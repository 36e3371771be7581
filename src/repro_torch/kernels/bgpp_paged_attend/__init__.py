"""Fused two-phase BGPP decode over paged bit-plane pools."""

from repro_torch.kernels.bgpp_paged_attend.ops import bgpp_paged_attend

__all__ = ["bgpp_paged_attend"]
