"""Ranks and collectives of the multi-rank Helix path (the port's
counterpart of the reference's ``shard_map`` collectives and
``launch/mesh.py``).

``init_ranks`` joins the process group: the caller passes the rendezvous
(``init_method``, e.g. ``file:///tmp/x`` or ``tcp://localhost:port``), the
world size and the rank, and picks the backend: ``nccl`` with one card per
rank, ``gloo`` where ranks share a card or run on the CPU.  Every group
gets a timeout (``TIMEOUT_S``), so a rank that diverges fails its peers
instead of hanging them.

``HelixGroup`` holds one rank's place in the ``kvp x tpa`` grid
(``core/sharding.RankLayout``: ``rank = t * kvp + k``; with ``ep`` also
its place among an MoE's experts, which need no collective of their
own), its KVP subgroup
(the ``kvp`` ranks that share t) and the whole group, and offers the
collectives of the decode and prefill steps: ``all_to_all`` over the KVP
subgroup (the attention fragments), ``all_gather`` (the LSEs over the
subgroup, the vocab-parallel logits over every rank) and ``all_reduce``
over every rank (the out-projection's and the FFN's partial sums).  Each
takes ``async_op=True`` and then returns a handle whose ``wait()`` returns
the result.  Every rank must create its groups in the same order: the
constructor creates them all, the same way on every rank.

Gloo takes CUDA tensors for some collectives and refuses them for others
(``all_to_all``).  When the caller chose gloo, this class stages every
collective of a CUDA tensor through pinned host memory (a copy to the host,
the collective there, a copy back) and nothing else does; with nccl
tensors stay on their card.  ``calls`` and ``host_ms`` count each
collective and the host time it held the caller, waits included.
"""
from __future__ import annotations

import datetime
import time

import torch
import torch.distributed as dist

from repro_torch.core.sharding import RankLayout

TIMEOUT_S = 60.0
BACKENDS = ("nccl", "gloo")
OPS = ("all_to_all", "all_gather", "all_reduce")


def init_ranks(rank: int, world: int, *, backend: str,
               init_method: str) -> None:
    """Join the default process group of ``world`` ranks as ``rank``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; choose from {BACKENDS}")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


class _Pending:
    """The handle of an asynchronous collective: ``wait()`` waits for it
    (on nccl the caller's stream then waits for the collective's), then
    finishes it (a staged result goes back to the card) and returns it."""

    def __init__(self, group, op, work, finish):
        self.group, self.op, self.work, self.finish = group, op, work, finish

    def wait(self):
        t0 = time.perf_counter()
        self.work.wait()
        out = self.finish()
        self.group.host_ms[self.op] += (time.perf_counter() - t0) * 1e3
        return out


class HelixGroup:
    """Collectives of one rank (see the module doc).  The default process
    group must be initialised (``init_ranks``) with ``kvp * tpa`` ranks;
    ``device`` is the rank's device (where its results go)."""

    def __init__(self, kvp: int, tpa: int = 1, *, device, ep: int = 1):
        world = dist.get_world_size()
        if kvp * tpa != world:
            raise ValueError(f"kvp {kvp} x tpa {tpa} != world {world}")
        self.layout = RankLayout(dist.get_rank(), kvp, tpa, ep)
        self.rank, self.kvp, self.tpa, self.world = (self.layout.rank, kvp,
                                                     tpa, world)
        self.ep = ep
        self.t, self.k = self.layout.t, self.layout.k
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        self.stage = self.backend == "gloo" and self.device.type == "cuda"
        # every rank creates every subgroup, in the same order
        subgroups = [dist.new_group(
            [t * kvp + k for k in range(kvp)],
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
            for t in range(tpa)]
        self.kvp_group = subgroups[self.t]
        self.all_group = dist.group.WORLD
        self.calls = dict.fromkeys(OPS, 0)
        self.host_ms = dict.fromkeys(OPS, 0.0)

    def reset_stats(self) -> None:
        self.calls = dict.fromkeys(OPS, 0)
        self.host_ms = dict.fromkeys(OPS, 0.0)

    def _host(self, x):
        """``x`` in pinned host memory (gloo with a CUDA tensor), else
        ``x`` itself, contiguous."""
        x = x.contiguous()
        if not self.stage:
            return x
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
        return h

    def _back(self, x):
        return x.to(self.device, non_blocking=True) if self.stage else x

    def _run(self, op, fn, out, async_op):
        t0 = time.perf_counter()
        self.calls[op] += 1
        work = fn(async_op)
        if async_op:
            self.host_ms[op] += (time.perf_counter() - t0) * 1e3
            return _Pending(self, op, work, lambda: self._back(out))
        res = self._back(out)
        self.host_ms[op] += (time.perf_counter() - t0) * 1e3
        return res

    def all_to_all(self, x, *, async_op: bool = False):
        """``x`` [kvp, ...] -> [kvp, ...] over the KVP subgroup: slice j of
        the result is KVP rank j's slice ``k`` (``jax.lax.all_to_all`` with
        ``split_axis = concat_axis = 0``)."""
        if x.shape[0] != self.kvp:
            raise ValueError(f"all_to_all takes [kvp={self.kvp}, ...] (got "
                             f"{tuple(x.shape)})")
        src = self._host(x)
        out = torch.empty_like(src)
        return self._run("all_to_all", lambda a: dist.all_to_all_single(
            out, src, group=self.kvp_group, async_op=a), out, async_op)

    def all_gather(self, x, *, over: str = "kvp", async_op: bool = False):
        """``x`` from every rank of the KVP subgroup (``over="kvp"``) or of
        the whole group (``"all"``), stacked in rank order: [n, *x.shape]."""
        group, n = ((self.kvp_group, self.kvp) if over == "kvp"
                    else (self.all_group, self.world))
        src = self._host(x).reshape(1, -1)
        flat = torch.empty((n, src.shape[1]), dtype=src.dtype,
                           device=src.device)
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        return self._run("all_gather", lambda a: gather(
            flat, src, group=group, async_op=a), flat.view(n, *x.shape),
            async_op)

    def all_gather_cols(self, x):
        """``x`` [..., n] of every rank joined along its last dim in rank
        order: [..., world * n] (the vocab-parallel head's logits; one
        ``all_gather`` over every rank, the same bits on every rank)."""
        full = self.all_gather(x, over="all")            # [world, ..., n]
        return full.movedim(0, -2).reshape(*x.shape[:-1], -1)

    def all_reduce(self, x, *, async_op: bool = False):
        """The sum of ``x`` over every rank.  A contiguous ``x`` that is not
        staged is summed in place; use the returned tensor."""
        buf = self._host(x)
        return self._run("all_reduce", lambda a: dist.all_reduce(
            buf, group=self.all_group, async_op=a), buf, async_op)
