from repro_torch.kernels.ssd_prefill.ops import ssd_prefill, ssd_prefill_plain
from repro_torch.kernels.ssd_prefill.ref import ssd_prefill_ref

__all__ = ["ssd_prefill", "ssd_prefill_plain", "ssd_prefill_ref"]
