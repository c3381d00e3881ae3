#!/usr/bin/env python3
"""ssd_prefill as one launch that hands the state from chunk to chunk (the
port's kernel) against three launches (every chunk's state, an in-order
fold, the outputs: ``scripts/torch_ssd_three_pass.cu``).

    python3 scripts/torch_ssd_three_pass_ab.py

Needs one sm_90 card.  Builds both with the flags of ``kernels/build.py``,
checks that they agree bit for bit, and times them in turns (one launch,
three, three, one: device time per call, calls queued behind a spin) at
mamba2-780m's widths (nh 48, hd 64, ds 128, lc 64), bf16 x/B/C from a
nonzero state, at B = 1, T = 1024 (a serve prefill), B = 4, T = 1024 and
B = 1, T = 4096.  Prints the card line and one JSON line of times.
"""
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)

import torch  # noqa: E402

from chip_smoke import (SSD_DS, SSD_HD, SSD_NH, card_line,  # noqa: E402
                        queued_ms, ssd_inputs)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd_prefill import ops  # noqa: E402


def three_pass_lib() -> ctypes.CDLL:
    """The three-launch form, built into the kernels' build directory."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    out = os.path.join(build.BUILD_DIR, "ssd_three_pass.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                    build.CSRC_DIR, "-o", out,
                    os.path.join(HERE, "scripts", "torch_ssd_three_pass.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ssd_three_pass_launch.argtypes = ([p, ll, ll] * 3 + [p] * 8
                                          + [i] * 9 + [p])
    lib.ssd_three_pass_launch.restype = i
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_ssd_three_pass_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(card_line())
    three = three_pass_lib()
    res = {}
    for b, t in ((1, 1024), (4, 1024), (1, 4096)):
        g = torch.Generator(device=dev).manual_seed(15)
        args, h0 = ssd_inputs(g, dev, b, t, torch.bfloat16)
        x, dt, a, bm, cm, d = args
        nc = len(ops.chunk_spans(t, 64))
        y = torch.empty(b, t, SSD_NH, SSD_HD, device=dev)
        h = torch.empty(b, SSD_NH, SSD_HD, SSD_DS, device=dev)
        ws = torch.empty(b * SSD_NH * nc * SSD_HD * SSD_DS, device=dev)
        dec = torch.empty(b * SSD_NH * nc, device=dev)

        def three_pass():
            rc = three.ssd_three_pass_launch(
                build.ptr(x), x.stride(0), x.stride(1),
                build.ptr(bm), bm.stride(0), bm.stride(1),
                build.ptr(cm), cm.stride(0), cm.stride(1),
                build.ptr(dt), build.ptr(a), build.ptr(d), build.ptr(h0),
                build.ptr(y), build.ptr(h), build.ptr(ws), build.ptr(dec), b,
                t, SSD_NH, SSD_HD, 1, SSD_DS, 64, nc, 1, build.stream())
            build.check(rc, three, "ssd three-pass")

        def one_launch():
            return ops.ssd_prefill(*args, h0=h0)

        got = one_launch()
        three_pass()
        torch.cuda.synchronize()
        same = torch.equal(got[0], y) and torch.equal(got[1], h)
        t_ms = {"one_launch_ms": [], "three_launches_ms": []}
        for name in ("one", "three", "three", "one"):
            fn = one_launch if name == "one" else three_pass
            key = "one_launch_ms" if name == "one" else "three_launches_ms"
            t_ms[key].append(queued_ms(fn))
        res[f"B={b} T={t}"] = {"bitwise_equal": same, **t_ms}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
