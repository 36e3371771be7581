"""Page-table-aware flash decode: single-token attention over paged pools."""

from repro_torch.kernels.paged_flash_decode.ops import paged_flash_decode

__all__ = ["paged_flash_decode"]
