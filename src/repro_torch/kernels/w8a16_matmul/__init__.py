from repro_torch.kernels.w8a16_matmul.ops import w8a16_matmul
from repro_torch.kernels.w8a16_matmul.ref import quantize_w8, w8a16_matmul_ref

__all__ = ["w8a16_matmul", "quantize_w8", "w8a16_matmul_ref"]
