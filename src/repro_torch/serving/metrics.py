"""Per-request lifecycle metrics of the engine (the port's copy of the
reference's ``serving/metrics.py``, trimmed): queue wait (submit ->
admission), TTFT (submit -> first token) and per-step TTL samples (gaps
between consecutive tokens), aggregated by ``summary()``.  The clock is
injectable (seconds, monotonic)."""
from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class RequestMetrics:
    rid: int
    submit_t: float
    admit_t: float | None = None
    first_token_t: float | None = None
    last_token_t: float | None = None
    finish_t: float | None = None
    finish_reason: str | None = None
    n_tokens: int = 0
    ttl_samples: list[float] = dataclasses.field(default_factory=list)

    @property
    def queue_wait(self) -> float | None:
        return None if self.admit_t is None else self.admit_t - self.submit_t

    @property
    def ttft(self) -> float | None:
        return (None if self.first_token_t is None
                else self.first_token_t - self.submit_t)


def _stats(vals) -> dict[str, float]:
    if not vals:
        return {"p50": 0.0, "p95": 0.0, "mean": 0.0, "n": 0}
    a = np.asarray(vals, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "mean": float(a.mean()), "n": len(vals)}


class EngineMetrics:
    """Lifecycle-event collector the engine drives; pure host Python."""

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self.requests: dict[int, RequestMetrics] = {}
        self.start_t = clock()

    def on_submit(self, rid: int) -> None:
        self.requests[rid] = RequestMetrics(rid=rid, submit_t=self.clock())

    def on_admit(self, rid: int) -> None:
        m = self.requests[rid]
        if m.admit_t is None:
            m.admit_t = self.clock()

    def on_token(self, rid: int, at: float | None = None) -> None:
        """TTFT on the first token, a TTL sample on each later one.  ``at``
        replaces the clock read: the windowed decode replays a window's
        tokens after one device call and gives each a time interpolated
        over the measured window, so TTL samples stay per token."""
        m = self.requests[rid]
        now = self.clock() if at is None else at
        if m.first_token_t is None:
            m.first_token_t = now
        else:
            m.ttl_samples.append(now - m.last_token_t)
        m.last_token_t = now
        m.n_tokens += 1

    def on_finish(self, rid: int, reason: str) -> None:
        m = self.requests[rid]
        m.finish_t = self.clock()
        m.finish_reason = reason

    def summary(self) -> dict:
        """p50/p95/mean of TTFT, TTL and queue wait (seconds) over finished
        requests, token throughput since construction, finish reasons."""
        fin = [m for m in self.requests.values() if m.finish_t is not None]
        dt = max(self.clock() - self.start_t, 1e-9)
        toks = sum(m.n_tokens for m in fin)
        return {
            "n_finished": len(fin),
            "n_tokens": toks,
            "throughput_tok_s": toks / dt,
            "ttft_s": _stats([m.ttft for m in fin if m.ttft is not None]),
            "ttl_s": _stats([s for m in fin for s in m.ttl_samples]),
            "queue_wait_s": _stats([m.queue_wait for m in fin
                                    if m.queue_wait is not None]),
            "finish_reasons": {r: sum(1 for m in fin if m.finish_reason == r)
                               for r in {m.finish_reason for m in fin}},
        }
