"""Process launch of the multi-rank Helix path.

``spawn(world, fn, *args, tpa=, ep=, backend=, device=)`` starts one process per
rank with the ``spawn`` start method (never fork: the parent may hold a CUDA
context).  Each process joins the process group through the rendezvous
(``init_method``; by default a fresh ``file://`` path under the temporary
directory), binds its device (``rank_device``), builds its
``core/dist.HelixGroup`` and returns ``fn(group, *args)``.  ``spawn``
returns the ranks' results in rank order.  A rank that raises, exits
non-zero or outlives ``timeout_s`` fails the launch: ``spawn`` stops every
process it started and raises ``RuntimeError`` with the rank's traceback.
``fn``, ``args`` and the results must pickle (``fn`` a module-level
function; results travel by value, tensors included); the
children re-import the caller's main module, so its top level must not run
work outside an ``if __name__ == "__main__"`` guard.
"""
from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.dist import HelixGroup, init_ranks


def rank_device(rank: int, backend: str, device) -> torch.device:
    """The device of ``rank``: the CPU for a CPU run; ``cuda:rank`` with
    nccl (one card per rank); the one card ``device`` names with gloo,
    where the ranks share it."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", device.index or 0)


def check_backend(world: int, backend: str, device) -> None:
    """Raise ``ValueError`` for a backend the devices cannot take: nccl
    needs CUDA and one card per rank (it refuses two ranks of one
    communicator on one card)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"dist backend {backend!r}; choose nccl or gloo")
    if backend == "nccl" and (torch.device(device).type != "cuda"
                              or torch.cuda.device_count() < world):
        raise ValueError(f"nccl needs one card per rank ({world} ranks, "
                         f"{torch.cuda.device_count()} cards); use gloo")


def _entry(rank, world, tpa, ep, backend, init_method, device, fn, args,
           out):
    try:
        dev = rank_device(rank, backend, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        init_ranks(rank, world, backend=backend, init_method=init_method)
        group = HelixGroup(world // tpa, tpa, device=dev, ep=ep)
        # pickled here: the queue would share tensors through file
        # descriptors that close when this process exits
        out.put((rank, True, pickle.dumps(fn(group, *args))))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(world: int, fn, *args, tpa: int = 1, ep: int = 1, backend: str,
          device, init_method: str | None = None, timeout_s: float = 900.0):
    """Run ``fn(group, *args)`` on ``world`` ranks (module doc; ``ep``: the
    groups' expert-parallel width); returns the results in rank order."""
    if world % tpa or world % ep:
        raise ValueError(f"tpa={tpa} and ep={ep} must divide world={world}")
    check_backend(world, backend, device)
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="helix-ranks-")
        init_method = "file://" + os.path.join(tmp, "rendezvous")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_entry, args=(
        r, world, tpa, ep, backend, init_method, str(device), fn, args,
        out))
        for r in range(world)]
    results, error = {}, None
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(results) < world and error is None:
            try:
                rank, ok, val = out.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    error = f"rank {dead[0]} exited with code " \
                            f"{procs[dead[0]].exitcode}"
                elif time.monotonic() > deadline:
                    error = f"the ranks outlived {timeout_s:.0f} s"
                continue
            if ok:
                results[rank] = pickle.loads(val)
            else:
                error = f"rank {rank} failed:\n{val}"
        for r, p in enumerate(procs):
            p.join(timeout=5 if error is not None else
                   max(0.0, deadline - time.monotonic()))
            if p.is_alive() and error is None:
                error = f"rank {r} outlived {timeout_s:.0f} s in its teardown"
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():            # SIGTERM ignored: kill it
                p.kill()
                p.join()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    if error is None:
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            error = f"rank {bad[0]} exited with code {procs[bad[0]].exitcode}"
    if error is not None:
        raise RuntimeError(f"multi-rank run failed: {error}")
    return [results[r] for r in range(world)]
