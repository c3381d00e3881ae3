#!/usr/bin/env python3
"""flash_prefill (B2) of two source trees on one card, timed in turns.

    python3 scripts/torch_prefill_ab.py --other DIR [--rounds 3]

``DIR`` is the root of another checkout of this repository (for example an
unpacked ``git archive`` of the parent commit in a gitignored directory).
Both trees' ``src/repro_torch/csrc/flash_prefill.cu`` are compiled with the
port's own ``nvcc`` flags and driven through this tree's wrapper, so only
the kernel differs.  Shapes: granite-3-2b's G = 4 rows of the kernel table
(B = 1, T = 1024 causal, 32/8 heads; and the chunk shape B = 4, T = 256 at
q_offset 0/256/512/768 over S = 1024), bf16, hsz 64.  Each round times
other, this, this, other with ``chip_smoke.queued_ms`` (20 calls queued
behind a spin kernel), after checking that both trees give the same bits.
Prints the card line, every time and each tree's mean.
"""
import argparse
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_prefill import ops  # noqa: E402


def compile_lib(root: str, out: str) -> ctypes.CDLL:
    src = os.path.join(root, "src", "repro_torch", "csrc", "flash_prefill.cu")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, src],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_prefill_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(chip_smoke.card_line())
    out_dir = build.BUILD_DIR
    os.makedirs(out_dir, exist_ok=True)
    libs = {"other": compile_lib(args.other, os.path.join(out_dir,
                                                          "ab_other.so")),
            "this": compile_lib(HERE, os.path.join(out_dir, "ab_this.so"))}
    g = torch.Generator(device=dev).manual_seed(4)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
    t, qh, kh, hsz = 1024, 32, 8, 64
    q, k, v = rnd(1, t, qh, hsz), rnd(1, t, kh, hsz), rnd(1, t, kh, hsz)
    qc, kc, vc = rnd(4, 256, qh, hsz), rnd(4, t, kh, hsz), rnd(4, t, kh, hsz)
    offs = torch.arange(0, t, 256, dtype=torch.int32, device=dev)
    shapes = {
        "B=1 T=1024 causal": lambda: ops.flash_prefill(q, k, v, causal=True),
        "chunks B=4 T=256 S=1024": lambda: ops.flash_prefill(
            qc, kc, vc, causal=True, q_offset=offs, seq_lens=offs + 256)}

    def use(tag):
        build.load = lambda name, lib=libs[tag]: lib

    for name, fn in shapes.items():
        outs = {}
        for tag in libs:
            use(tag)
            outs[tag] = fn()
        torch.cuda.synchronize()
        same = torch.equal(outs["other"].view(torch.int16),
                           outs["this"].view(torch.int16))
        print(f"{name}: both trees give the same bits: {same}")
        if not same:
            return 1
        times = {tag: [] for tag in libs}
        for _ in range(args.rounds):
            for tag in ("other", "this", "this", "other"):
                use(tag)
                times[tag].append(chip_smoke.queued_ms(fn))
        for tag, ms in times.items():
            print(f"{name} {tag}: " + " ".join(f"{x:.4f}" for x in ms)
                  + f" ms; mean {sum(ms) / len(ms):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
