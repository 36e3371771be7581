"""One BGPP scoring round over bit-planar packed keys."""

from repro_torch.kernels.bgpp_score.ops import bgpp_score_heads, bgpp_score_round

__all__ = ["bgpp_score_heads", "bgpp_score_round"]
