"""Kernel-backend registry of the port (counterpart of the reference's
``kernels/registry.py``).

Five families are ported, each with backends ``ref`` (plain PyTorch) and
``cuda`` (hand-written kernel for sm_90a):

  ============== =============================== ==========================
  family         used by                         kernel source
  ============== =============================== ==========================
  flash_decode   Helix decode attention          csrc/flash_decode.cu
                 (core/helix.helix_attention;    (fixed and paged layouts,
                 fp and int8 caches)             fp and int8 modes,
                                                 grouped-suffix mode)
  prefix_pass    shared-prefix pass of grouped   csrc/prefix_pass.cu
                 decode (flash_decode groups=)
  flash_prefill  prefill attention               csrc/flash_prefill.cu
                 (models/attention.              (fixed and paged layouts;
                 prefill_attention)              bf16 on wgmma, f32 on
                                                 CUDA cores)
  w8a16_matmul   int8 lm_head of the decode step csrc/w8a16_matmul.cu
                 (models/decode_model.head_matmul)
  ssd_prefill    Mamba2 SSD scan core of the     csrc/ssd_prefill.cu
                 prefill (models/ssm.ssd_chunked)
  ============== =============================== ==========================

The reference's kernel modes still without a port would be listed in
``NOT_PORTED`` (none is left); they are not registered as working.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

BACKENDS = ("ref", "cuda")

FAMILIES = {
    "flash_decode": "Helix decode attention (core/helix.helix_attention)",
    "prefix_pass": "grouped shared-prefix decode (flash_decode groups=)",
    "flash_prefill": "prefill attention (models/attention.prefill_attention)",
    "w8a16_matmul": "int8 lm_head (models/decode_model.head_matmul)",
    "ssd_prefill": "Mamba2 SSD scan (models/ssm.ssd_chunked)",
}

# reference kernels (src/repro/kernels/...) and modes that have no port yet
NOT_PORTED: dict[str, str] = {}


def _counters():
    from repro_torch.kernels.flash_decode import ops as dec
    from repro_torch.kernels.flash_prefill import ops as pre
    from repro_torch.kernels.ssd_prefill.ops import counter as ssd
    from repro_torch.kernels.w8a16_matmul.ops import counter as mm
    return {"flash_decode": dec.counter, "flash_decode_kv8": dec.counter_kv8,
            "flash_decode_paged": dec.counter_paged,
            "flash_decode_grouped": dec.counter_grouped,
            "flash_decode_contiguous": dec.counter_contiguous,
            "prefix_pass": dec.counter_prefix,
            "flash_prefill": pre.counter,
            "flash_prefill_paged": pre.counter_paged,
            "flash_prefill_noncausal": pre.counter_noncausal,
            "flash_prefill_cross": pre.counter_cross,
            "w8a16_matmul": mm, "ssd_prefill": ssd}


def launch_counts() -> dict[str, int]:
    """Launches of each ported kernel so far in this process
    (``flash_decode_kv8`` / ``flash_decode_paged`` /
    ``flash_decode_grouped`` / ``flash_decode_contiguous``: the int8-mode /
    paged / grouped-suffix / contiguous-layout launches among
    ``flash_decode``'s; ``flash_prefill_paged`` / ``flash_prefill_noncausal``:
    the paged / non-causal launches among ``flash_prefill``'s, and
    ``flash_prefill_cross`` the non-causal ones whose kv length differs from
    the query length)."""
    return {name: c.n for name, c in _counters().items()}


def reset_launch_counts() -> None:
    for c in _counters().values():
        c.n = 0


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add ``delta`` (a difference of two ``launch_counts()``) to the
    counters: a CUDA graph's replay launches what its capture counted."""
    counters = _counters()
    for name, n in delta.items():
        counters[name].n += n


def available(family: str, backend: str) -> tuple[bool, str]:
    """(usable on this host, reason).  ``cuda`` needs a CUDA device of
    compute capability 9.0 and a successful build of the family's kernel."""
    if family not in FAMILIES:
        raise ValueError(f"unknown or unported kernel family {family!r}; "
                         f"ported: {sorted(FAMILIES)}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    if backend == "ref":
        return True, "any device"
    if not torch.cuda.is_available():
        return False, "no CUDA device"
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        return False, f"needs compute capability 9.0 (found {cap})"
    try:
        build.load(family)
    except build.KernelUnavailable as e:
        return False, f"build failed: {e}"
    return True, "sm_90 + built"


def backend_table() -> str:
    """Per-family backend availability, plus the kernels not ported."""
    rows = [f"{'family':<14s} " + "".join(f"{b:<34s}" for b in BACKENDS)
            + "used by"]
    for name, used_by in FAMILIES.items():
        cells = []
        for b in BACKENDS:
            ok, why = available(name, b)
            cells.append("yes" if ok else f"no: {why}"[:32])
        rows.append(f"{name:<14s} " + "".join(f"{c:<34s}" for c in cells)
                    + used_by)
    for name, what in NOT_PORTED.items():
        rows.append(f"{name:<14s} not ported: {what}")
    return "\n".join(rows)
