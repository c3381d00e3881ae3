"""TTL governor: trades batch-class concurrency for interactive latency (the
port's copy of the reference's ``serving/governor.py``).

Each engine step it reads the windowed interactive TTL p95
(``EngineMetrics.recent_ttl_p95``) and

  * **sheds** when the p95 is past the target: it lowers the scheduler's
    ``batch_cap`` below the running batch slots and names the youngest
    decoding batch-class request (the least sunk work) to preempt; the
    engine preempts it through the host tier's spill, so the shed work
    resumes from restored pages with no prefill chunk;
  * **recovers** after ``recover_steps`` healthy steps in a row: it raises
    ``batch_cap`` by one slot toward ``max_batch``;
  * **holds** when the estimator has no fresh interactive samples (none
    yet, or none for ``recover_steps`` steps), so an old window cannot keep
    the cap down after interactive traffic has drained.

``cooldown_steps`` spaces the sheds.  It reads only host-side metrics and
scheduler state.
"""
from __future__ import annotations

import dataclasses

from repro_torch.serving.scheduler import SLO_INTERACTIVE


@dataclasses.dataclass(frozen=True)
class GovernorConfig:
    """The interactive p95 TTL target (seconds of the engine clock; a
    ``VirtualClock`` makes the decisions replayable), the estimator's
    window and sample floor, the shed cooldown, the healthy steps before a
    slot comes back, and the floor the cap never sheds below."""
    ttl_target_s: float
    window: int = 32
    min_samples: int = 8
    cooldown_steps: int = 4
    recover_steps: int = 12
    min_batch_slots: int = 0


class TTLGovernor:
    """Per-step TTL feedback on the scheduler's ``batch_cap`` (module doc).
    The engine makes the preemption; ``step`` names the victim."""

    def __init__(self, cfg: GovernorConfig, max_batch: int):
        if cfg.ttl_target_s <= 0 or not 0 <= cfg.min_batch_slots <= max_batch:
            raise ValueError(f"bad governor config {cfg} for max_batch "
                             f"{max_batch}")
        self.cfg = cfg
        self.max_batch = max_batch
        self.sheds = 0                 # batch slots preempted to spill
        self.cap_raises = 0            # slots given back to the cap
        self._steps = 0
        self._last_action = -10**9
        self._healthy_streak = 0
        self._stale_steps = 0
        self._last_seen = 0

    def step(self, metrics, sched, batch_rids: list[int]) -> int | None:
        """One decision.  ``batch_rids`` are the decoding batch-class
        requests, youngest first.  Returns the rid to preempt, or None;
        moves ``sched.batch_cap`` either way."""
        self._steps += 1
        cfg = self.cfg
        seen = metrics.class_samples(SLO_INTERACTIVE)
        self._stale_steps = (0 if seen > self._last_seen
                             else self._stale_steps + 1)
        self._last_seen = seen
        p95 = metrics.recent_ttl_p95(SLO_INTERACTIVE, window=cfg.window,
                                     min_samples=cfg.min_samples)
        healthy = (p95 is None or p95 <= cfg.ttl_target_s
                   or self._stale_steps >= cfg.recover_steps)
        if not healthy:
            self._healthy_streak = 0
            if self._steps - self._last_action < cfg.cooldown_steps:
                return None
            self._last_action = self._steps
            n_batch = len(batch_rids)
            sched.batch_cap = max(cfg.min_batch_slots,
                                  min(sched.batch_cap, n_batch) - 1)
            if n_batch > cfg.min_batch_slots:
                self.sheds += 1
                return batch_rids[0]
            return None
        self._healthy_streak += 1
        if (self._healthy_streak >= cfg.recover_steps
                and sched.batch_cap < self.max_batch):
            sched.batch_cap += 1
            self.cap_raises += 1
            self._healthy_streak = 0
        return None
