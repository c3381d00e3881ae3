from repro_torch.kernels.flash_prefill.ops import flash_prefill
from repro_torch.kernels.flash_prefill.ref import (flash_prefill_paged_ref,
                                                   flash_prefill_ref)

__all__ = ["flash_prefill", "flash_prefill_paged_ref", "flash_prefill_ref"]
