"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds).  Libraries go to ``src/repro_torch/_build/`` (listed
in ``.gitignore``), named by a hash of their source and flags, and are built
at first use.  ``build_all`` starts one ``nvcc`` per source at once.

Dispatch rule shared by every kernel wrapper (``route``): tensors on the CPU
take the plain PyTorch version; CUDA tensors launch the kernel or raise.
There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from dataclasses import dataclass, field

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
KERNELS = ("flash_decode", "prefix_pass", "flash_prefill", "w8a16_matmul",
           "ssd_prefill")
# No --use_fast_math / -prec-div=false: the int8 quantizers need IEEE
# division and round-half-to-even to match the plain versions bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelUnavailable(RuntimeError):
    """A CUDA kernel could not be built or loaded."""


@dataclass
class Launches:
    """Plain launch counter of one kernel wrapper: ``n`` grows by one at
    each launch of the CUDA kernel, and nowhere else."""
    n: int = 0


@dataclass
class BuiltKernel:
    name: str
    lib: ctypes.CDLL
    seconds: float                  # build time (0.0 when already built)
    ptxas: list[str] = field(default_factory=list)   # -Xptxas -v lines


_LOADED: dict[str, BuiltKernel] = {}


def route(*tensors) -> str:
    """``"plain"`` when every given tensor lies on the CPU, ``"cuda"`` when
    every one lies on a CUDA device; anything else raises."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return "plain"
    if kinds == {"cuda"}:
        return "cuda"
    raise ValueError(f"kernel operands must all be CPU or all CUDA tensors "
                     f"(got devices {sorted(kinds)})")


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise KernelUnavailable(f"nvcc not found at {path} (set CUDA_HOME)")
    return path


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in [name + ".cu"] + sorted(f for f in os.listdir(CSRC_DIR)
                                      if f.endswith(".cuh")):
        with open(os.path.join(CSRC_DIR, fn), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str, nvcc: str):
    out = _lib_path(name)
    if os.path.exists(out):
        return out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def build_all(names=KERNELS) -> dict[str, BuiltKernel]:
    """Build (in parallel, one ``nvcc`` per source) and load ``names``."""
    todo = [n for n in names if n not in _LOADED]
    if todo:
        nvcc = nvcc_path()
        t0 = time.perf_counter()
        started = {n: _start(n, nvcc) for n in todo}
        for n, (out, job) in started.items():
            ptxas: list[str] = []
            secs = 0.0
            if job is not None:
                proc, tmp = job
                log, _ = proc.communicate()
                secs = time.perf_counter() - t0
                if proc.returncode != 0:
                    raise KernelUnavailable(
                        f"nvcc failed for {n}.cu (rc {proc.returncode}):\n{log}")
                os.replace(tmp, out)
                # the spill line ("N bytes stack frame, N bytes spill
                # stores, ...") does not start with "ptxas"
                ptxas = [ln.strip() for ln in log.splitlines()
                         if "spill" in ln or "(C75" in ln
                         or ("ptxas" in ln and ("registers" in ln
                                                or "smem" in ln
                                                or "entry function" in ln))]
            _LOADED[n] = BuiltKernel(n, ctypes.CDLL(out), secs, ptxas)
    return {n: _LOADED[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    return build_all((name,))[name].lib


def check(rc: int, lib: ctypes.CDLL, name: str) -> None:
    """Raise when a launcher returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def stream(device: torch.device | None = None) -> int:
    """The current CUDA stream of ``device`` (default: the current device)
    as an int for a ``c_void_p`` argument, read without building a
    ``torch.cuda.Stream`` where this build of torch allows it."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(device).cuda_stream
    return raw(torch.cuda.current_device() if device is None else device.index)


def per_row(x, b: int, dev):
    """(None, x) for an int, which a kernel takes as a scalar (no device
    tensor, no host-to-device copy); else ([B] int32 on ``dev``, 0)."""
    if isinstance(x, int):
        return None, x
    if not (isinstance(x, torch.Tensor) and x.dtype == torch.int32
            and x.device == dev and x.shape == (b,) and x.is_contiguous()):
        x = torch.as_tensor(x, dtype=torch.int32, device=dev).reshape(
            -1).expand(b).contiguous()
    return x, 0


def dtype_code(dt: torch.dtype) -> int:
    """0 = float32, 1 = bfloat16: the two cache/activation types the
    kernels take (math is float32 inside either way)."""
    if dt == torch.float32:
        return 0
    if dt == torch.bfloat16:
        return 1
    raise ValueError(f"kernels take float32 or bfloat16 tensors, not {dt}")
