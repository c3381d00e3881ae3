"""Trace-driven workloads: schema-versioned request traces and their
generators (the port's copy of the reference's ``serving/workload.py``).

A **trace** is a list of ``TraceRow``s, one per request, each pinning

    (rid, arrival_step, tenant, slo_class, prompt_len, max_tokens,
     session_id, seed)

so one trace replays identically through any engine configuration.
Prompts are made from the row's ``seed`` (``prompt_tokens``), never
stored.  On disk a trace is JSONL: a header ``{"schema": 1, "kind":
"helix-trace", "meta": {...}}`` and one row object per line
(``save_trace``/``load_trace``; another schema version is refused).
``trace_id`` hashes the canonical row bytes, the reference's for the same
rows.

Generators: ``poisson_arrival_steps`` (exponential gaps),
``bursty_arrival_steps`` (closed bursts with Poisson gaps between them) and
``generate_trace``, which mixes tenants by their ``TenantSpec`` shares and
draws each row's lengths from its tenant's ranges, with the reference's
draws for one seed.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

from repro_torch.serving.scheduler import (SLO_CLASSES, SLO_INTERACTIVE,
                                           Request, TenantConfig)

TRACE_SCHEMA = 1
TRACE_KIND = "helix-trace"

# row fields in canonical serialization order (schema version 1)
_ROW_FIELDS = ("rid", "arrival_step", "tenant", "slo_class", "prompt_len",
               "max_tokens", "session_id", "seed")


@dataclasses.dataclass(frozen=True)
class TraceRow:
    """One trace request: its arrival (in engine steps), tenant and SLO
    class, prompt and output lengths, an optional session id, and the
    ``seed`` its prompt tokens are made from."""
    rid: int
    arrival_step: int
    tenant: str = "default"
    slo_class: str = SLO_INTERACTIVE
    prompt_len: int = 32
    max_tokens: int = 16
    session_id: str | None = None
    seed: int = 0

    def validate(self) -> None:
        """Raise ``ValueError`` unless the row is well-formed (schema 1)."""
        bad = [what for what, ok in (
            ("rid >= 0", self.rid >= 0),
            ("arrival_step >= 0", self.arrival_step >= 0),
            ("a tenant name", bool(self.tenant)),
            (f"slo_class in {SLO_CLASSES}", self.slo_class in SLO_CLASSES),
            ("prompt_len >= 1", self.prompt_len >= 1),
            ("max_tokens >= 1", self.max_tokens >= 1),
            ("seed >= 0", self.seed >= 0)) if not ok]
        if bad:
            raise ValueError(f"trace row {self} needs {', '.join(bad)}")

    def to_json(self) -> str:
        """Canonical one-line JSON (fixed key order, so equal rows hash
        alike in ``trace_id``)."""
        return json.dumps({k: getattr(self, k) for k in _ROW_FIELDS})

    @classmethod
    def from_json(cls, line: str) -> "TraceRow":
        d = json.loads(line)
        unknown = set(d) - set(_ROW_FIELDS)
        if unknown:
            raise ValueError(f"unknown trace row fields: {sorted(unknown)}")
        row = cls(**d)
        row.validate()
        return row


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's slice of a generated workload: its fair-queue
    ``weight``, SLO class, ``share`` of arrivals and inclusive prompt and
    output length ranges (None: the generator's defaults)."""
    name: str
    weight: float = 1.0
    slo_class: str = SLO_INTERACTIVE
    share: float = 1.0
    prompt_len: tuple[int, int] | None = None
    max_tokens: tuple[int, int] | None = None

    def tenant_config(self) -> TenantConfig:
        return TenantConfig(name=self.name, weight=self.weight)


def parse_tenants(spec: str) -> tuple[TenantSpec, ...]:
    """``"name[:weight[:slo[:share]]],..."`` (e.g.
    ``"chat:2:interactive:0.5,bulk:1:batch:0.5"``) -> ``TenantSpec``s;
    weight defaults to 1, the class to interactive, the share to the
    weight."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) > 4:
            raise ValueError(f"bad tenant spec {part!r}")
        name = bits[0]
        weight = float(bits[1]) if len(bits) > 1 and bits[1] else 1.0
        slo = bits[2] if len(bits) > 2 and bits[2] else SLO_INTERACTIVE
        if slo not in SLO_CLASSES:
            raise ValueError(f"tenant {name!r}: slo {slo!r} not in "
                             f"{SLO_CLASSES}")
        share = float(bits[3]) if len(bits) > 3 and bits[3] else weight
        out.append(TenantSpec(name=name, weight=weight, slo_class=slo,
                              share=share))
    if not out:
        raise ValueError(f"no tenants in spec {spec!r}")
    return tuple(out)


# ------------------------------------------------------------- arrivals
def poisson_arrival_steps(n: int, rate: float, seed: int = 0) -> list[int]:
    """The engine step of each of ``n`` Poisson arrivals, ``rate`` per step
    on average (exponential gaps of mean ``1/rate``)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(rate, 1e-9), size=n)
    return np.floor(np.cumsum(gaps)).astype(int).tolist()


def bursty_arrival_steps(n: int, rate: float, burst: int = 4,
                         seed: int = 0) -> list[int]:
    """Arrivals in closed bursts of ``burst``, Poisson gaps between bursts
    sized so the long-run average stays ``rate`` per step."""
    if burst < 1:
        raise ValueError(f"burst must be >= 1 (got {burst})")
    rng = np.random.default_rng(seed)
    n_bursts = -(-n // burst)
    gaps = rng.exponential(burst / max(rate, 1e-9), size=n_bursts)
    starts = np.floor(np.cumsum(gaps)).astype(int)
    return [int(starts[i // burst]) for i in range(n)]


# ------------------------------------------------------------ generator
def generate_trace(n: int, *, arrival: str = "poisson", rate: float = 0.5,
                   burst: int = 4,
                   tenants: tuple[TenantSpec, ...] = (TenantSpec("default"),),
                   prompt_len: int = 32, max_tokens: int = 16,
                   seed: int = 0) -> list[TraceRow]:
    """An ``n``-request trace: arrivals by ``arrival`` (``"poisson"`` |
    ``"bursty"`` | ``"batch"``, all at step 0), tenants drawn by their
    normalised ``share``, lengths uniform over each tenant's ranges
    (``prompt_len``/``max_tokens`` for specs without).  Arrivals use
    ``seed`` itself; tenants and lengths a derived stream, so adding
    tenants never moves the arrivals."""
    if arrival == "poisson":
        steps = poisson_arrival_steps(n, rate, seed)
    elif arrival == "bursty":
        steps = bursty_arrival_steps(n, rate, burst, seed)
    elif arrival == "batch":
        steps = [0] * n
    else:
        raise ValueError(f"unknown arrival shape {arrival!r}; choose from "
                         "('poisson', 'bursty', 'batch')")
    rng = np.random.default_rng([seed, 0xC0FFEE])
    shares = np.asarray([max(t.share, 0.0) for t in tenants], np.float64)
    if not shares.sum() > 0:
        raise ValueError("all tenant shares are zero")
    shares = shares / shares.sum()
    rows = []
    for rid in range(n):
        t = tenants[int(rng.choice(len(tenants), p=shares))]
        plo, phi = t.prompt_len or (prompt_len, prompt_len)
        mlo, mhi = t.max_tokens or (max_tokens, max_tokens)
        rows.append(TraceRow(
            rid=rid, arrival_step=int(steps[rid]), tenant=t.name,
            slo_class=t.slo_class,
            prompt_len=int(rng.integers(plo, phi + 1)),
            max_tokens=int(rng.integers(mlo, mhi + 1)),
            seed=int(rng.integers(0, 2**31 - 1))))
    for r in rows:
        r.validate()
    return rows


# ------------------------------------------------------------ trace I/O
def save_trace(path, rows, meta: dict | None = None) -> None:
    """Write ``rows`` as a JSONL trace: the header, then one canonical row
    per line."""
    with open(path, "w") as f:
        f.write(json.dumps({"schema": TRACE_SCHEMA, "kind": TRACE_KIND,
                            "meta": meta or {}}) + "\n")
        for r in rows:
            r.validate()
            f.write(r.to_json() + "\n")


def load_trace(path) -> list[TraceRow]:
    """Read a trace written by ``save_trace``: the header's kind and schema
    version are checked (another version raises) and so is every row."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"empty trace file: {path}")
    head = json.loads(lines[0])
    if head.get("kind") != TRACE_KIND:
        raise ValueError(f"{path}: not a {TRACE_KIND} file "
                         f"(header {head!r})")
    if head.get("schema") != TRACE_SCHEMA:
        raise ValueError(f"{path}: unsupported trace schema "
                         f"{head.get('schema')!r} (this reader speaks "
                         f"{TRACE_SCHEMA})")
    rows = [TraceRow.from_json(ln) for ln in lines[1:]]
    rids = [r.rid for r in rows]
    if len(rids) != len(set(rids)):
        raise ValueError("duplicate rids in trace")
    return rows


def trace_id(rows) -> str:
    """Short content hash of a trace (canonical row JSON): the name of the
    workload a measurement ran."""
    h = hashlib.sha256()
    for r in rows:
        h.update(r.to_json().encode())
        h.update(b"\n")
    return h.hexdigest()[:12]


# ------------------------------------------------------- materialization
def prompt_tokens(row: TraceRow, vocab: int, shared_prefix=()) -> list[int]:
    """``row``'s synthetic prompt: the workload's ``shared_prefix`` (cut to
    the row's length) and a suffix drawn from the row's own seed."""
    shared = list(shared_prefix)[:row.prompt_len]
    rng = np.random.default_rng(row.seed)
    suffix = rng.integers(0, vocab, row.prompt_len - len(shared)).tolist()
    return shared + suffix


def requests_from_trace(rows, vocab: int, *, eos_id: int | None = None,
                        shared_prefix=()) -> list[Request]:
    """Engine ``Request``s of ``rows``, their prompts made by
    ``prompt_tokens``, with each row's tenant, SLO class and session."""
    return [Request(rid=r.rid, prompt=prompt_tokens(r, vocab, shared_prefix),
                    max_new_tokens=r.max_tokens, eos_id=eos_id,
                    session_id=r.session_id, tenant=r.tenant,
                    slo_class=r.slo_class)
            for r in rows]
