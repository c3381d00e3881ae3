"""Per-request lifecycle metrics of the engine (the port's copy of the
reference's ``serving/metrics.py``): queue wait (submit -> admission), TTFT
(submit -> first token) and per-step TTL samples (gaps between consecutive
tokens), aggregated by ``summary()`` over the whole run, per tenant and per
SLO class, with the host tier's and the TTL governor's counters.

The clock is injectable (seconds, monotonic).  ``VirtualClock`` is the
deterministic one: a cost model the engine advances by each step's work, so
two runs of one trace give equal summaries, and shedding batch slots lowers
the modelled interactive TTL, which gives the governor
(``serving/governor.py``) a replayable signal.  ``recent_ttl_p95`` is the
governor's estimator: p95 over the last ``window`` TTL samples of one SLO
class, None until ``min_samples`` have come.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np


class VirtualClock:
    """Deterministic cost-model clock: each ``advance`` moves the time by

        base_s * steps + decode_slot_s * decode_slots
                       + prefill_token_s * prefill_tokens

    so a fuller step costs more modelled time.  The default coefficients
    are the reference's."""

    def __init__(self, base_s: float = 1e-3, decode_slot_s: float = 5e-4,
                 prefill_token_s: float = 1e-4):
        self.base_s = base_s
        self.decode_slot_s = decode_slot_s
        self.prefill_token_s = prefill_token_s
        self._t = 0.0

    def __call__(self) -> float:
        return self._t

    def advance(self, *, steps: int = 0, decode_slots: int = 0,
                prefill_tokens: int = 0) -> None:
        """Advance the modelled time by one tranche of engine work."""
        self._t += (self.base_s * steps
                    + self.decode_slot_s * decode_slots
                    + self.prefill_token_s * prefill_tokens)


@dataclasses.dataclass
class RequestMetrics:
    """One request's timeline (seconds, engine clock) and counts; a
    preemption is a spill (pages saved to the host tier) or a drop (the
    resume re-prefills)."""
    rid: int
    submit_t: float
    tenant: str = "default"
    slo_class: str = "interactive"
    admit_t: float | None = None
    first_token_t: float | None = None
    last_token_t: float | None = None
    finish_t: float | None = None
    finish_reason: str | None = None
    n_tokens: int = 0
    n_preempts: int = 0
    n_preempt_spills: int = 0
    n_preempt_drops: int = 0
    ttl_samples: list[float] = dataclasses.field(default_factory=list)
    restore_samples: list[float] = dataclasses.field(default_factory=list)

    @property
    def queue_wait(self) -> float | None:
        return None if self.admit_t is None else self.admit_t - self.submit_t

    @property
    def ttft(self) -> float | None:
        return (None if self.first_token_t is None
                else self.first_token_t - self.submit_t)


def _pct(vals, q) -> float:
    return float(np.percentile(np.asarray(vals, np.float64), q))


def _stats(vals) -> dict[str, float]:
    if not vals:
        return {"p50": 0.0, "p95": 0.0, "mean": 0.0, "n": 0}
    return {"p50": _pct(vals, 50), "p95": _pct(vals, 95),
            "mean": float(np.mean(vals)), "n": len(vals)}


class EngineMetrics:
    """Lifecycle-event collector the engine drives; pure host Python."""

    # counters always in summary() (zeros without a host store or governor)
    TIER_COUNTERS = ("spills", "restores", "restores_failed",
                     "checksum_mismatches", "store_evictions",
                     "resume_reprefill_chunks")
    GOVERNOR_COUNTERS = ("governor_sheds", "governor_cap_raises")

    def __init__(self, clock=time.monotonic,
                 ttl_target_s: float | None = None,
                 recent_window: int = 256):
        self.clock = clock
        self.ttl_target_s = ttl_target_s
        self.requests: dict[int, RequestMetrics] = {}
        self.start_t = clock()
        self.counters: dict[str, int] = {
            k: 0 for k in self.TIER_COUNTERS + self.GOVERNOR_COUNTERS}
        # the last TTL samples as (slo_class, seconds), bounded
        self._recent: deque[tuple[str, float]] = deque(maxlen=recent_window)
        self._class_samples: dict[str, int] = {}

    # ------------------------------------------------------------ events
    def on_submit(self, rid: int, tenant: str = "default",
                  slo_class: str = "interactive") -> None:
        self.requests[rid] = RequestMetrics(rid=rid, submit_t=self.clock(),
                                            tenant=tenant,
                                            slo_class=slo_class)

    def on_admit(self, rid: int) -> None:
        """First admission only: a resumed request keeps its queue wait."""
        m = self.requests[rid]
        if m.admit_t is None:
            m.admit_t = self.clock()

    def on_token(self, rid: int, at: float | None = None) -> None:
        """TTFT on the first token, a TTL sample on each later one (also
        into the per-class ring).  ``at`` replaces the clock read: the
        windowed decode replays a window's tokens after one device call and
        gives each its in-window time, so TTL samples stay per token."""
        m = self.requests[rid]
        now = self.clock() if at is None else at
        if m.first_token_t is None:
            m.first_token_t = now
        else:
            ttl = now - m.last_token_t
            m.ttl_samples.append(ttl)
            self._recent.append((m.slo_class, ttl))
            self._class_samples[m.slo_class] = \
                self._class_samples.get(m.slo_class, 0) + 1
        m.last_token_t = now
        m.n_tokens += 1

    def on_preempt(self, rid: int, spilled: bool = False) -> None:
        """A preemption; ``spilled``: its pages went to the host tier."""
        m = self.requests[rid]
        m.n_preempts += 1
        if spilled:
            m.n_preempt_spills += 1
        else:
            m.n_preempt_drops += 1

    def on_restore(self, rid: int, seconds: float) -> None:
        """One restore of ``rid`` took ``seconds`` from its admission to
        its committed pages."""
        self.requests[rid].restore_samples.append(seconds)

    def bump(self, counter: str, n: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n

    def set_counter(self, counter: str, value: int) -> None:
        """Pin a counter (mirrors a monotonic counter of the store)."""
        self.counters[counter] = int(value)

    def on_finish(self, rid: int, reason: str) -> None:
        m = self.requests[rid]
        m.finish_t = self.clock()
        m.finish_reason = reason

    # --------------------------------------------------- TTL estimation
    def class_samples(self, slo_class: str) -> int:
        """TTL samples ever recorded for ``slo_class``: the governor's sign
        that the class still produces tokens."""
        return self._class_samples.get(slo_class, 0)

    def recent_ttl_p95(self, slo_class: str = "interactive",
                       window: int | None = None,
                       min_samples: int = 8) -> float | None:
        """p95 TTL of the last ``window`` recent samples of one class; None
        until ``min_samples`` have come."""
        vals = [s for cls, s in self._recent if cls == slo_class]
        if window is not None:
            vals = vals[-window:]
        if len(vals) < min_samples:
            return None
        return _pct(vals, 95)

    # ----------------------------------------------------------- summary
    def _good_tokens(self, m: RequestMetrics) -> int:
        """Tokens counted as goodput: all of a batch request's or without a
        TTL target; an interactive request's first token and the tokens
        whose TTL met the target."""
        if self.ttl_target_s is None or m.slo_class != "interactive":
            return m.n_tokens
        ok = sum(1 for s in m.ttl_samples if s <= self.ttl_target_s)
        return ok + (1 if m.first_token_t is not None else 0)

    def _agg(self, fin: list[RequestMetrics], dt: float) -> dict:
        ttls = [s for m in fin for s in m.ttl_samples]
        toks = sum(m.n_tokens for m in fin)
        misses = (0 if self.ttl_target_s is None else
                  sum(1 for m in fin if m.slo_class == "interactive"
                      for s in m.ttl_samples if s > self.ttl_target_s))
        inter_ttls = sum(len(m.ttl_samples) for m in fin
                         if m.slo_class == "interactive")
        return {
            "n_finished": len(fin),
            "n_tokens": toks,
            "throughput_tok_s": toks / dt,
            "goodput_tok_s": sum(self._good_tokens(m) for m in fin) / dt,
            "ttl_target_miss_rate": misses / max(inter_ttls, 1),
            "ttft_s": _stats([m.ttft for m in fin if m.ttft is not None]),
            "ttl_s": _stats(ttls),
            "queue_wait_s": _stats([m.queue_wait for m in fin
                                    if m.queue_wait is not None]),
        }

    def summary(self) -> dict:
        """p50/p95/mean of TTFT, TTL and queue wait (seconds) over finished
        requests, throughput and goodput since construction, the same per
        tenant and per SLO class, the recent per-class TTL p95, the
        preemption split, restore times, the tier and governor counters and
        the finish reasons."""
        fin = [m for m in self.requests.values() if m.finish_t is not None]
        dt = max(self.clock() - self.start_t, 1e-9)
        out = self._agg(fin, dt)
        out.update({
            "ttl_target_s": self.ttl_target_s or 0.0,
            "ttl_recent_p95_s": {
                cls: (self.recent_ttl_p95(cls, min_samples=1) or 0.0)
                for cls in ("interactive", "batch")},
            "per_tenant": {t: self._agg([m for m in fin if m.tenant == t],
                                        dt)
                           for t in sorted({m.tenant for m in fin})},
            "per_class": {c: self._agg([m for m in fin if m.slo_class == c],
                                       dt)
                          for c in sorted({m.slo_class for m in fin})},
            "preempts": sum(m.n_preempts for m in fin),
            "preempt_spills": sum(m.n_preempt_spills for m in fin),
            "preempt_drops": sum(m.n_preempt_drops for m in fin),
            "restore_s": _stats([s for m in fin for s in m.restore_samples]),
            **{k: self.counters.get(k, 0)
               for k in self.TIER_COUNTERS + self.GOVERNOR_COUNTERS},
            "finish_reasons": {r: sum(1 for m in fin if m.finish_reason == r)
                               for r in {m.finish_reason for m in fin}},
        })
        return out
