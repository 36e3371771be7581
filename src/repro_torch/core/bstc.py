"""BSTC — BS-Sparsity-enabled Two-state Coding (paper §3.2), on tensors.

Counterpart of :mod:`repro.core.bstc`.  Lossless compression of the
sign-magnitude bit planes of an int8 weight.  Each m-bit *column* of a
group of m plane rows is coded as

    all-zero column  ->  1'b0
    non-zero column  ->  {1'b1, m bits of the column pattern}

so one (m x H) group plane takes ``H + m·nnz_cols`` bits instead of
``m·H``.  A plane is coded only when its bit sparsity clears the threshold
and coding actually shrinks it; the other planes and the sign plane stay
raw (8:1 packed bits).

The reference encodes offline on the host with a Python loop over group
rows.  Here the encoder is vectorised tensor ops on the weight's own
device: a cumulative sum gives every non-zero column its slot in the
pattern stream, and one scatter fills the padded pattern buffer.  So a
full-width model is coded on the card in seconds, and the output is
bit-identical to the reference's numpy encoder (bitmap, patterns with the
same cap, nnz, stream lengths, raw planes, sign, plane sparsity).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import bitslice

DEFAULT_SPARSITY_THRESHOLD = 0.65  # paper Fig. 8(b): CR>1 needs SR > ~65%


@dataclasses.dataclass
class EncodedPlane:
    """One bit plane of an (M, H) magnitude tensor, grouped into M//m rows.

    bitmap:   (M//m, H) uint8 {0,1} — the two-state indicators.
    patterns: (M//m, cap) uint8 — the non-zero column patterns in column
              order, each row padded to ``cap`` = the max nnz over rows
              (at least 1).
    nnz:      (M//m,) int32 — valid prefix length of each pattern row.
    """

    bitmap: torch.Tensor
    patterns: torch.Tensor
    nnz: torch.Tensor
    m: int
    encoded_bits: int  # exact stream length: sum(H + m*nnz_g)
    raw_bits: int

    @property
    def storage_bits(self) -> int:
        """Bits of the padded representation (bitmap + patterns)."""
        return self.bitmap.numel() + self.patterns.numel() * self.m


def _group_patterns(plane: torch.Tensor, m: int) -> torch.Tensor:
    """(M, H) {0,1} plane -> (M//m, H) int32 column patterns; bit j of
    group g's pattern is plane row ``g*m + j``."""
    M, H = plane.shape
    grp = plane.reshape(M // m, m, H).to(torch.int32)
    shifts = torch.arange(m, dtype=torch.int32, device=plane.device).reshape(1, m, 1)
    return (grp << shifts).sum(1, dtype=torch.int32)


def encode_plane(plane: torch.Tensor, m: int) -> EncodedPlane:
    """plane: (M, H) {0,1}.  Groups m rows; codes the columns two-state."""
    M, H = plane.shape
    if M % m:
        raise ValueError(f"rows {M} not divisible by m={m}")
    G = M // m
    patt = _group_patterns(plane, m)
    bitmap = (patt != 0).to(torch.uint8)
    nnz = bitmap.sum(1, dtype=torch.int32)
    cap = max(int(nnz.max()), 1) if G else 1
    # each non-zero column's slot in its row's stream; zero columns aim at a
    # spare column `cap`, which every one of them fills with its pattern 0
    pos = torch.cumsum(bitmap, 1, dtype=torch.int64) - 1
    dest = torch.where(bitmap.bool(), pos, torch.full_like(pos, cap))
    buf = torch.zeros((G, cap + 1), dtype=torch.uint8, device=plane.device)
    buf.scatter_(1, dest, patt.to(torch.uint8))
    return EncodedPlane(
        bitmap=bitmap,
        patterns=buf[:, :cap].contiguous(),
        nnz=nnz,
        m=m,
        encoded_bits=int(bitmap.numel() + m * int(nnz.sum())),
        raw_bits=M * H,
    )


def expand_patterns(patt: torch.Tensor, m: int) -> torch.Tensor:
    """(G, H) m-bit group patterns -> (G*m, H) {0,1} uint8 plane rows.

    Bit j of the pattern of group g is row ``g*m + j`` (the one place that
    states the group-row bit order, as in the reference)."""
    G, H = patt.shape
    shifts = torch.arange(m, dtype=torch.int32, device=patt.device).reshape(1, m, 1)
    bits = (patt.to(torch.int32)[:, None, :] >> shifts) & 1
    return bits.to(torch.uint8).reshape(G * m, H)


def decode_plane(enc: EncodedPlane) -> torch.Tensor:
    """Inverse of :func:`encode_plane` -> (M, H) uint8 plane.  Column h's
    pattern sits at ``cumsum(bitmap)[h] - 1`` of its row's stream; zero
    columns read slot 0 and are masked out."""
    pos = torch.cumsum(enc.bitmap.to(torch.int32), 1, dtype=torch.int64) - 1
    pos = pos.clamp(0, enc.patterns.shape[1] - 1)
    vals = torch.gather(enc.patterns, 1, pos)
    patt = torch.where(enc.bitmap != 0, vals, torch.zeros_like(vals))
    return expand_patterns(patt, enc.m)


# ---------------------------------------------------------------------------
# whole-weight container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BSTCWeight:
    """A per-channel-symmetric int8 weight stored bit-slice first.

    Each magnitude plane is either BSTC-coded (``encoded[p]``) or raw
    packed bits (``raw_planes[p]``, (M, H//8) uint8); the sign plane is
    always raw (paper Fig. 8)."""

    shape: Tuple[int, int]
    m: int
    nbits: int
    scale: torch.Tensor  # (M,) float32 per-channel scale
    encoded: List[Optional[EncodedPlane]]  # per plane; None => raw
    raw_planes: List[Optional[torch.Tensor]]  # packed uint8 (M, H//8) when raw
    sign: torch.Tensor  # packed uint8 (M, H//8)
    plane_sparsity: torch.Tensor  # (nbits,) float32 measured bit sparsity

    @property
    def raw_bits(self) -> int:
        return 8 * self.shape[0] * self.shape[1]

    @property
    def encoded_bits(self) -> int:
        """Stream bits: the sign plane, raw planes whole, coded planes' streams."""
        n = self.shape[0] * self.shape[1]
        return n + sum(n if e is None else e.encoded_bits for e in self.encoded)

    @property
    def compression_ratio(self) -> float:
        return self.raw_bits / self.encoded_bits

    @property
    def hbm_bytes(self) -> int:
        """Bytes of the padded arrays (bitmap packable 8:1, a byte a pattern)."""
        b = self.sign.numel()
        for e, r in zip(self.encoded, self.raw_planes):
            b += r.numel() if e is None else e.bitmap.numel() // 8 + e.patterns.numel()
        return b


def encode_weight(
    w_q: torch.Tensor,
    scale,
    m: int = 4,
    nbits: int = bitslice.WEIGHT_MAG_BITS,
    threshold: float = DEFAULT_SPARSITY_THRESHOLD,
    force_planes: Optional[Sequence[int]] = None,
) -> BSTCWeight:
    """BSTC compression of an int8 (M, H) weight, on ``w_q``'s device.

    ``force_planes`` pins the coded set; otherwise a plane is coded iff its
    bit sparsity clears ``threshold`` AND coding shrinks it
    (``encoded_bits < raw_bits``) — the reference's rule."""
    w = w_q.to(torch.int32)
    M, H = w.shape
    sign, mag = bitslice.to_sign_magnitude(w)
    n = M * H
    # one host read for every plane's count; count / n in float64 is the
    # correctly rounded quotient numpy's mean gives (its sum is exact)
    counts = torch.stack([((mag >> p) & 1).sum() for p in range(nbits)]).tolist()
    sparsity = [1.0 - c / n for c in counts]
    encoded: List[Optional[EncodedPlane]] = []
    raw_planes: List[Optional[torch.Tensor]] = []
    for p in range(nbits):
        plane = (mag >> p) & 1
        if force_planes is not None:
            enc = encode_plane(plane, m) if p in force_planes else None
        elif sparsity[p] >= threshold:
            enc = encode_plane(plane, m)
            if enc.encoded_bits >= enc.raw_bits:  # would expand: keep raw
                enc = None
        else:
            enc = None
        encoded.append(enc)
        raw_planes.append(None if enc is not None else bitslice.pack_bits(plane))
    return BSTCWeight(
        shape=(M, H),
        m=m,
        nbits=nbits,
        scale=torch.as_tensor(scale, dtype=torch.float32).to(w.device),
        encoded=encoded,
        raw_planes=raw_planes,
        sign=bitslice.pack_bits(sign),
        plane_sparsity=torch.tensor(sparsity, dtype=torch.float64)
        .to(torch.float32).to(w.device),
    )


def decode_weight(bw: BSTCWeight) -> torch.Tensor:
    """Exact reconstruction -> int8 (M, H)."""
    planes = [decode_plane(e) if e is not None else bitslice.unpack_bits(r)
              for e, r in zip(bw.encoded, bw.raw_planes)]
    mag = bitslice.from_bitplanes(torch.stack(planes))
    sign = bitslice.unpack_bits(bw.sign)
    return bitslice.from_sign_magnitude(sign, mag).to(torch.int8)


def compression_ratio_closed_form(m: int, col_sparsity: float) -> float:
    """CR = mH / (H + m·nnz) with nnz = (1-sc)·H  (paper Fig. 8b curves)."""
    return m / (1.0 + m * (1.0 - col_sparsity))


def expected_column_sparsity(bit_sparsity: float, m: int) -> float:
    """Under independent bits, P(column of m bits all zero) = bs**m."""
    return bit_sparsity**m
