"""Seeded fault injection for the host KV tier (the port's copy of the
reference's ``serving/faults.py``; numpy only).

A ``FaultPlan`` says which host-tier faults to inject and how often, from
one seed, so a run under faults replays the same fault sequence every
time.  The four faults mirror the tier's real failure modes:

  ``restore_fail``  the restore is lost: ``HostPageStore.restore`` returns
                    nothing and the engine re-prefills;
  ``corrupt``       one stored page is damaged after its checksum was taken
                    (a flipped byte) or its generation stamp is bumped, so
                    the restore's verification catches it;
  ``store_full``    the store refuses a save: the spill degrades to
                    dropping the pages;
  ``delay``         a slow tier: a restore's pages arrive ``delay_steps``
                    engine steps late while the other slots decode.

The draws come from one numpy generator seeded at construction, in a fixed
order per operation (``_KINDS``), so one (seed, operation stream) pair
always gives the same faults, those of the reference for the same pair.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["FaultPlan", "FaultInjector"]

# injectable fault kinds, in the fixed per-operation draw order
_KINDS = ("store_full", "corrupt", "restore_fail", "delay")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded fault schedule of the host page store: each rate is an
    injection probability in [0, 1] (0, the default, never fires and draws
    nothing); ``delay_steps`` is how many engine steps a delayed restore
    withholds its pages.  ``parse("seed=1,restore_fail=0.5,delay=1")``
    builds one from the CLI's spec."""

    seed: int = 0
    restore_fail: float = 0.0
    corrupt: float = 0.0
    store_full: float = 0.0
    delay: float = 0.0
    delay_steps: int = 2

    def __post_init__(self):
        for kind in _KINDS:
            p = getattr(self, kind)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{kind} rate {p} outside [0, 1]")
        if self.delay_steps < 0:
            raise ValueError(f"delay_steps {self.delay_steps} < 0")

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """A plan from a ``k=v,k=v`` spec (``--fault-plan``): the keys are
        the fields, ``seed``/``delay_steps`` ints and the rates floats; an
        empty spec is the inert default plan."""
        kw: dict[str, float | int] = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            if "=" not in part:
                raise ValueError(f"fault-plan field {part!r} is not k=v")
            k, v = (s.strip() for s in part.split("=", 1))
            if k not in {f.name for f in dataclasses.fields(cls)}:
                raise ValueError(f"unknown fault-plan field {k!r}")
            kw[k] = int(v) if k in ("seed", "delay_steps") else float(v)
        return cls(**kw)

    def injector(self) -> "FaultInjector":
        """A fresh draw stream of this plan (one per store)."""
        return FaultInjector(self)


class FaultInjector:
    """The stateful half of a ``FaultPlan``: one seeded draw stream.
    ``draw(kind)`` is True when the fault fires and tallies it in
    ``injected``; a zero rate consumes no generator state, so no plan and
    an inert plan behave alike."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._rng = np.random.default_rng(plan.seed)
        self.injected: dict[str, int] = {k: 0 for k in _KINDS}

    @property
    def active(self) -> bool:
        """True when any fault has a non-zero rate."""
        return any(getattr(self.plan, k) > 0 for k in _KINDS)

    def draw(self, kind: str) -> bool:
        """One Bernoulli draw for ``kind``; tallies and returns the hit."""
        p = getattr(self.plan, kind)
        if p <= 0.0:
            return False
        hit = bool(self._rng.random() < p)
        if hit:
            self.injected[kind] += 1
        return hit

    def pick(self, n: int) -> int:
        """A seeded index in [0, n) (corruption targets)."""
        return int(self._rng.integers(0, max(n, 1)))
