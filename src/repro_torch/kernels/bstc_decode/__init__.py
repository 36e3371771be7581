"""BSTC plane decode: bitmap + pattern stream -> (G, H) group patterns."""

from repro_torch.kernels.bstc_decode.ops import (  # noqa: F401
    EncodedPlaneOperands,
    bstc_decode_patterns,
    prepare_encoded_plane,
)
