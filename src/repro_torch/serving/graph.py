"""Decode windows replayed as CUDA graphs: the port's counterpart of the
reference's jitted ``lax.scan`` window (``build_serve_multistep``), one
dispatch and one host sync per window of N tokens.

``WindowRunner(multistep)`` is called like the multistep itself.
On CPU tensors it runs the eager loop.  On the card, before the first
window of a batch size, one eager window that advances no row makes the
kernels' launch plans and workspaces (``kernels/flash_decode/ops.py``
``_PLANS``, ``_workspace``), which the capture must find made
(``prepare``).  Then the window is captured once into a
``torch.cuda.CUDAGraph``, and every window is one replay of it.  The
kernels launch on the current stream (``kernels/build.stream``), which is
the capture stream while the graph is captured.

What the graph reads and writes:

  * the small leaves (``total_len`` and the sampler's ``sample_*``) and the
    window's inputs (tokens, budgets, EOS ids, forced tokens) are copied
    into static buffers before each replay, and the leaves the window
    advances (``total_len``, ``sample_idx``) come back as new tensors;
  * the large leaves (caches, pool planes, scales, ``block_tables``, SSM
    state) are captured in place: the engine must update them in place and
    never rebind them.  Each replay checks their addresses and raises if
    one moved.

The kernel wrappers' launch counters tick while the graph is captured,
when nothing runs: the capture takes its ticks back, and each replay adds
them.  A capture or a replay that fails raises; nothing falls back to the
eager loop.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.kvcache import SAMPLING_TYPES
from repro_torch.kernels import registry

SMALL_LEAVES = ("total_len",) + tuple(SAMPLING_TYPES)


@dataclasses.dataclass
class _Graph:
    graph: Any                     # torch.cuda.CUDAGraph
    model: Any                     # the weights it was captured with
    args: tuple                    # static window inputs
    small: dict                    # static small leaves (inputs)
    large: dict                    # large leaf -> captured data_ptr
    out_block: torch.Tensor        # outputs, in the graph's memory
    cur: torch.Tensor
    out_small: dict
    launches: dict                 # kernel launches of one replay


class WindowRunner:
    """Runs ``multistep(model, state, tokens, budgets, eos_ids, forced,
    n_forced)`` windows: eagerly on the CPU, as one CUDA graph replay per
    window on the card (module doc).  ``captures``/``replays`` count the
    graphs made and replayed."""

    def __init__(self, multistep: Callable):
        self.multistep = multistep
        self._graphs: dict = {}
        self.captures = 0
        self.replays = 0

    def __call__(self, model, state, *args):
        if args[0].device.type != "cuda":
            return self.multistep(model, state, *args)
        self.prepare(model, state, *args)
        return self.replay(model, state, *args)

    def prepare(self, model, state, *args) -> None:
        """On the card, before the first window of a batch size: one eager
        window with every budget 0, which makes the kernels' launch plans
        and workspaces and changes no live row (a frozen row holds its
        length and SSM state, and its append writes the K/V of its current
        token at its next slot, as the window's first step will), then the
        capture.  Nothing on the CPU or once captured."""
        tokens, budgets = args[0], args[1]
        if (tokens.device.type != "cuda"
                or (tokens.shape[0], tokens.device) in self._graphs):
            return
        self.multistep(model, state, tokens, torch.zeros_like(budgets),
                       *args[2:])
        self.capture(model, state, *args)

    def capture(self, model, state, *args) -> None:
        """Capture one window over ``state``'s large leaves (the small
        leaves and ``args`` only give shapes; nothing runs)."""
        tokens = args[0]
        dev = tokens.device
        small = {k: torch.empty_like(state[k]) for k in SMALL_LEAVES
                 if k in state}
        large = {k: v for k, v in state.items() if k not in small}
        static = tuple(torch.empty_like(a) for a in args)
        before = registry.launch_counts()
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.graph(graph, stream=stream):
            out_block, cur, new_state = self.multistep(
                model, {**large, **small}, *static)
        torch.cuda.current_stream(dev).wait_stream(stream)
        after = registry.launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        registry.add_launch_counts({k: -n for k, n in launches.items()})
        out_small = {k: v for k, v in new_state.items()
                     if k in small and v is not small[k]}
        self._graphs[(tokens.shape[0], dev)] = _Graph(
            graph=graph, model=model, args=static, small=small,
            large={k: v.data_ptr() for k, v in large.items()},
            out_block=out_block, cur=cur, out_small=out_small,
            launches=launches)
        self.captures += 1

    def replay(self, model, state, *args):
        """One window as a replay of the captured graph: same results as
        ``multistep(model, state, *args)``."""
        tokens = args[0]
        g = self._graphs[(tokens.shape[0], tokens.device)]
        if model is not g.model:
            raise RuntimeError("the window graph was captured with other "
                               "weights")
        if set(state) != set(g.large) | set(g.small):
            raise RuntimeError(f"decode state leaves {sorted(state)} differ "
                               "from the captured ones "
                               f"{sorted(set(g.large) | set(g.small))}")
        for k, ptr in g.large.items():
            if state[k].data_ptr() != ptr:
                raise RuntimeError(
                    f"decode state leaf {k!r} moved since the window graph "
                    "was captured (large leaves must be updated in place)")
        for k, buf in g.small.items():
            buf.copy_(state[k])
        for buf, a in zip(g.args, args):
            buf.copy_(a)
        g.graph.replay()
        registry.add_launch_counts(g.launches)
        self.replays += 1
        new_state = dict(state)
        for k, v in g.out_small.items():
            new_state[k] = v.clone()
        return g.out_block.clone(), g.cur.clone(), new_state
