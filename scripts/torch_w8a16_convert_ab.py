#!/usr/bin/env python3
"""Is the int8 -> bf16 conversion a limit of the port's w8a16 kernel?

    python3 scripts/torch_w8a16_convert_ab.py

Needs one sm_90 card.  Builds ``src/repro_torch/csrc/w8a16_matmul.cu`` as
it is (byte permute into the mantissa of 2^23, one f32 subtract) and a
variant whose conversion goes through the int-to-float unit
(``(float)(int8_t)byte``), both with the flags of ``kernels/build.py``,
checks that they agree bit for bit, and times them in turns (kernel,
variant, variant, kernel: device time per call, calls queued behind a spin)
at the int8 lm_head of granite-3-2b (K = 2048, N = 49664), M = 4 and 8,
bf16 x.  Prints the card line and one JSON
line of times.
"""
import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)

import torch  # noqa: E402

from chip_smoke import card_line, queued_ms  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.w8a16_matmul import quantize_w8  # noqa: E402
from repro_torch.kernels.w8a16_matmul import ops  # noqa: E402

I2F = '''template <int E>
__device__ __forceinline__ uint32_t i8_f32(uint32_t w) {
  return __float_as_uint(
      (float)(int8_t)(((w ^ 0x80808080u) >> (8 * E)) & 0xffu));
}'''


def variant_lib() -> ctypes.CDLL:
    """The variant, built into the kernels' build directory."""
    src = open(os.path.join(build.CSRC_DIR, "w8a16_matmul.cu")).read()
    pat = re.compile(r"template <int E>\n__device__ __forceinline__ uint32_t "
                     r"i8_f32\(uint32_t w\) \{.*?\n\}", re.S)
    new, n = pat.subn(I2F, src)
    if n != 1:
        sys.exit("conversion function not found in w8a16_matmul.cu")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(build.BUILD_DIR, "w8a16_i2f.cu")
    with open(cu, "w") as f:
        f.write(new)
    out = os.path.join(build.BUILD_DIR, "w8a16_i2f.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                    build.CSRC_DIR, "-o", out, cu], check=True,
                   capture_output=True)
    return ctypes.CDLL(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_w8a16_convert_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(card_line())
    kernel = ops._bind(build.load("w8a16_matmul"))
    variant = ops._bind(variant_lib())
    g = torch.Generator(device=dev).manual_seed(4)
    k, n = 2048, 49664
    qw, sc = quantize_w8(torch.randn(k, n, generator=g, device=dev))
    res = {}
    for m in (4, 8):
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        outs = {}

        def call(fn, name):
            out = outs.setdefault(name, torch.empty(m, n, dtype=x.dtype,
                                                    device=dev))
            build.check(fn(build.ptr(x), build.ptr(qw), build.ptr(sc),
                           build.ptr(out), 1, m, k, n, build.stream()),
                        build.load("w8a16_matmul"), "w8a16")

        call(kernel, "kernel")
        call(variant, "variant")
        torch.cuda.synchronize()
        same = torch.equal(outs["kernel"].view(torch.int16),
                           outs["variant"].view(torch.int16))
        t = {"kernel": [], "variant": []}
        for name in ("kernel", "variant", "variant", "kernel"):
            fn = kernel if name == "kernel" else variant
            t[name].append(queued_ms(lambda: call(fn, name)))
        res[f"M={m}"] = {"ctas": ops.blocks(m, n), "bitwise_equal": same,
                         "kernel_ms": t["kernel"], "i2f_variant_ms":
                         t["variant"]}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
