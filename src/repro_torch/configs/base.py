"""Model configuration schema + architecture registry (the port's copy).

Counterpart of :mod:`repro.configs.base`, cut to what the serving slices
serve: dense GQA transformers, the serve-time weight format (bf16, int8 or
BSTC-coded int8), the BGPP decode knobs and speculative decoding.  The
port keeps its own copy (it imports nothing of ``repro``).  Each architecture file registers its published config plus a reduced
``smoke`` variant used by the CPU tests.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple


# serve-time weight numerics (repro_torch.serving.weights reads the knob
# once, when a serve step is built)
WEIGHT_FORMATS = ("bf16", "int8", "bstc")


@dataclasses.dataclass(frozen=True)
class MCBPOptions:
    """MCBP knobs the serving slices read: the weight path, the BGPP decode
    plan and speculative decoding."""

    group_size: int = 4  # BRCR/BSTC group m (paper §5.2 DSE: m=4)
    bstc_threshold: float = 0.65  # a plane is coded iff its bit sparsity clears it
    bgpp_rounds: int = 4  # progressive bit-plane rounds (MSB first)
    bgpp_keep_ratio: float = 0.25  # k_max = ceil(ratio * S) full-precision rows
    # weight numerics of the decode projections: "bf16" | "int8" | "bstc"
    weight_format: str = "bf16"
    # speculative decoding (repro_torch.serving.spec_decode): propose
    # draft_gamma tokens a slot with a truncated-bit-plane forward, verify
    # them through serve_step, accept or roll back per slot; greedy output
    # is identical to non-speculative decode
    spec_decode: bool = False
    draft_gamma: int = 4
    # MSB magnitude bit planes the draft weights keep (1..8 of int8's 7
    # magnitude bits + sign; >= 7 keeps full int8 precision)
    draft_planes: int = 4

    def __post_init__(self):
        if self.weight_format not in WEIGHT_FORMATS:
            raise ValueError(
                f"weight_format={self.weight_format!r} is not one of "
                f"{WEIGHT_FORMATS} (config mcbp.weight_format or the "
                f"Scheduler's weight_format argument)"
            )
        if not 1 <= int(self.draft_gamma):
            raise ValueError(
                f"draft_gamma={self.draft_gamma!r} must be >= 1 (tokens "
                f"drafted per speculative round)"
            )
        if not 1 <= int(self.draft_planes) <= 8:
            raise ValueError(
                f"draft_planes={self.draft_planes!r} must be in 1..8 (MSB "
                f"magnitude bit-planes the draft weights keep)"
            )


def apply_weight_format_override(cfg, fmt: Optional[str] = None):
    """Return ``cfg`` with its ``weight_format`` knob replaced (``None``
    keeps the config's value) — the code path behind ``--weight-format``
    and the Scheduler's ``weight_format`` argument.  Validation happens in
    :meth:`MCBPOptions.__post_init__`, so a typo raises here."""
    if fmt is None:
        return cfg
    return dataclasses.replace(
        cfg, mcbp=dataclasses.replace(cfg.mcbp, weight_format=str(fmt)))


def apply_bgpp_overrides(cfg, rounds: Optional[int] = None,
                         keep_ratio: Optional[float] = None):
    """Return ``cfg`` with its BGPP decode knobs replaced (``None`` keeps
    the config's value) — the code path behind ``--bgpp-rounds`` /
    ``--bgpp-keep-ratio``."""
    if rounds is None and keep_ratio is None:
        return cfg
    mo = dataclasses.replace(
        cfg.mcbp,
        bgpp_rounds=cfg.mcbp.bgpp_rounds if rounds is None else int(rounds),
        bgpp_keep_ratio=cfg.mcbp.bgpp_keep_ratio if keep_ratio is None
        else float(keep_ratio),
    )
    return dataclasses.replace(cfg, mcbp=mo)


def apply_spec_decode_overrides(cfg, enabled: Optional[bool] = None,
                                gamma: Optional[int] = None,
                                planes: Optional[int] = None):
    """Return ``cfg`` with its speculative-decoding knobs replaced (``None``
    keeps the config's value) — the code path behind ``--spec-decode`` /
    ``--draft-gamma`` / ``--draft-planes``.  Validation happens in
    :meth:`MCBPOptions.__post_init__`."""
    if enabled is None and gamma is None and planes is None:
        return cfg
    mo = dataclasses.replace(
        cfg.mcbp,
        spec_decode=cfg.mcbp.spec_decode if enabled is None else bool(enabled),
        draft_gamma=cfg.mcbp.draft_gamma if gamma is None else int(gamma),
        draft_planes=cfg.mcbp.draft_planes if planes is None else int(planes),
    )
    return dataclasses.replace(cfg, mcbp=mo)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One dense decoder-only transformer."""

    name: str
    family: str  # dense
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float = 10_000.0
    activation: str = "swiglu"
    norm: str = "rms"
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    mcbp: MCBPOptions = MCBPOptions()

    @property
    def q_dim(self) -> int:
        """Width of the concatenated query heads."""
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        """Width of the concatenated key (or value) heads."""
        return self.num_kv_heads * self.head_dim

    def layer_attn_window(self, i: int) -> Tuple[str, int]:
        """(mask_kind, window) for layer i: every layer is full causal."""
        return ("causal", 0)


ARCH_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
SMOKE_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]) -> None:
    """Register an architecture's full and smoke configs under ``name``."""
    ARCH_REGISTRY[name] = full
    SMOKE_REGISTRY[name] = smoke


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    """The registered config ``name`` (its smoke variant with ``smoke``)."""
    reg = SMOKE_REGISTRY if smoke else ARCH_REGISTRY
    if name not in reg:
        raise KeyError(f"unknown arch {name!r}; have {sorted(reg)}")
    return reg[name]()
