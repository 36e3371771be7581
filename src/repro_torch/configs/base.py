"""Model configuration schema + architecture registry (the port's copy).

Counterpart of :mod:`repro.configs.base`: every field of the reference's
``ModelConfig`` (dense, MoE, SSM, hybrid, encoder-decoder and VLM
families), its per-layer helpers and its parameter counts, with the port's
own cut of ``MCBPOptions`` (the serve-time weight format, the BGPP decode
knobs and speculative decoding).  The port keeps its own copy (it imports
nothing of ``repro``).  Each architecture file registers its published
config plus a reduced ``smoke`` variant used by the CPU tests.

The port serves every family of the reference: ``dense``, ``moe``,
``vlm``, ``ssm``, ``hybrid`` and ``enc_dec``.  The transformer-only entry
points (prefill, chunked admission, the Scheduler, the launcher) refuse
ssm, hybrid and enc_dec with :func:`require_transformer`'s error, as the
reference does: those decode through ``make_serve_step`` directly.
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
    """One architecture: the reference's fields, with the port's MCBP knobs."""

    name: str
    family: str  # dense | moe | ssm | hybrid | enc_dec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention structure
    rope_theta: float = 10_000.0
    rope_theta_local: float = 0.0  # gemma3: local layers use a different base
    sliding_window: int = 0  # window of the local layers (0 = none)
    global_every: int = 0  # layer i is global iff (i + 1) % global_every == 0
    chunk_attention: int = 0  # llama4 chunked-local size (0 = off)
    attn_logit_softcap: float = 0.0
    qk_norm: bool = False
    embed_scale: bool = False  # gemma: embeddings times sqrt(d_model)
    post_norms: bool = False  # gemma3 sandwich norms

    # FFN / MoE
    activation: str = "swiglu"  # swiglu | geglu | gelu
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1  # layer i is MoE iff num_experts > 0 and i % moe_every == moe_offset
    moe_offset: int = 0
    moe_shared_ff: int = 0  # llama4 shared expert width (0 = none)
    moe_capacity_factor: float = 1.25

    # SSM (mamba2 / jamba)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    attn_every: int = 0  # hybrid: layer i is attention iff i % attn_every == attn_offset
    attn_offset: int = 0

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0
    d_audio: int = 0

    # VLM (paligemma)
    vision_tokens: int = 0
    d_vision: int = 0

    norm: str = "rms"  # rms | ln
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

    def layer_is_global_attn(self, i: int) -> bool:
        """Whether layer i attends the whole sequence."""
        if self.sliding_window <= 0:
            return self.chunk_attention <= 0  # chunked archs: global_every rule
        if self.global_every <= 0:
            return False
        return (i + 1) % self.global_every == 0

    def layer_attn_window(self, i: int) -> Tuple[str, int]:
        """(mask_kind, window) for layer i; ``("causal", 0)`` is global."""
        if self.chunk_attention > 0:
            if self.global_every > 0 and (i + 1) % self.global_every == 0:
                return ("causal", 0)
            return ("chunked", self.chunk_attention)
        if self.sliding_window > 0:
            if self.global_every > 0 and (i + 1) % self.global_every == 0:
                return ("causal", 0)
            return ("sliding", self.sliding_window)
        return ("causal", 0)

    def layer_is_moe(self, i: int) -> bool:
        """Whether layer i's FFN is a mixture of experts."""
        return self.num_experts > 0 and i % self.moe_every == self.moe_offset

    def layer_is_attention(self, i: int) -> bool:
        """Attention (not a mamba mixer) at layer i: every layer of the
        attention families, none of ``ssm``, the interleave of ``hybrid``."""
        if self.family != "hybrid":
            return self.family != "ssm"
        return self.attn_every > 0 and i % self.attn_every == self.attn_offset

    def active_params(self) -> int:
        """Approximate active (per-token) parameter count."""
        return _param_count(self, active_only=True)

    def total_params(self) -> int:
        """Approximate total parameter count."""
        return _param_count(self, active_only=False)


def _ffn_params(cfg: ModelConfig, d_ff: int) -> int:
    mult = 3 if cfg.activation in ("swiglu", "geglu") else 2
    return mult * cfg.d_model * d_ff


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    """The reference's closed-form parameter count (norms left out)."""
    d = cfg.d_model
    total = cfg.vocab_size * d  # embeddings
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d
    for i in range(cfg.num_layers):
        if cfg.layer_is_attention(i):
            total += d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
        else:  # mamba mixer
            d_in = cfg.ssm_expand * d
            nheads = d_in // cfg.ssm_head_dim
            total += d * (2 * d_in + 2 * cfg.ssm_state + nheads) + d_in * d
        if cfg.family == "ssm":
            continue  # mamba2 interleaves mixers only, no separate FFN
        if cfg.layer_is_moe(i):
            e = cfg.experts_per_token if active_only else cfg.num_experts
            total += e * _ffn_params(cfg, cfg.d_ff) + d * cfg.num_experts
            if cfg.moe_shared_ff:
                total += _ffn_params(cfg, cfg.moe_shared_ff)
        else:
            total += _ffn_params(cfg, cfg.d_ff)
    for _ in range(cfg.encoder_layers):  # whisper's encoder, roughly
        total += 4 * cfg.d_model * cfg.q_dim + _ffn_params(cfg, cfg.d_ff)
    return total


# the transformer families (every layer attention, the MoE family with an
# expert FFN in every layer, the VLM's image prefix): the ones the
# reference's prefill, chunked admission, Scheduler, launcher and converted
# weight formats take
TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")
# families the port serves: the transformer stack, the attention-free ssm
# (models/mamba2.py), jamba's hybrid (models/hybrid.py) and whisper's enc_dec
# (models/whisper.py); the last three decode through make_serve_step alone
SERVED_FAMILIES = TRANSFORMER_FAMILIES + ("ssm", "hybrid", "enc_dec")

# how a family outside the transformer stack decodes (the reference's
# Scheduler: "ssm/hybrid/enc-dec decode through make_serve_step directly")
_DIRECT_DECODE = {
    "ssm": "from a zero state",
    "hybrid": "from a zero state",
    "enc_dec": "from position 0, over the encoder memory the caller puts in the cache's "
               "cross_k / cross_v",
}


def require_served(cfg, who: str) -> None:
    """Refuse a family the port does not know: a ``ValueError`` naming it.
    A config of the transformer families that carries experts must put an
    expert FFN in every layer (``moe_every == 1``), as the reference's
    transformer asserts; a stack that alternates MoE and dense FFNs is of
    the hybrid family."""
    if cfg.family not in SERVED_FAMILIES:
        raise ValueError(
            f"{who}: {cfg.name} is of family {cfg.family!r}; the port serves the "
            f"{', '.join(SERVED_FAMILIES)} families")
    if cfg.family in TRANSFORMER_FAMILIES and cfg.num_experts > 0 and cfg.moe_every != 1:
        raise ValueError(
            f"{who}: {cfg.name} is of family {cfg.family!r} with moe_every="
            f"{cfg.moe_every}; a transformer puts an expert FFN in every layer, and "
            f"a stack that alternates MoE and dense FFNs is of the hybrid family "
            f"(models/hybrid.py)")


def require_transformer(cfg, who: str) -> None:
    """Refuse what :func:`require_served` refuses, and the ssm, hybrid and
    enc_dec families at an entry point of the transformer families alone,
    with the reference's reason: they decode through ``make_serve_step``
    directly."""
    require_served(cfg, who)
    if cfg.family not in TRANSFORMER_FAMILIES:
        raise ValueError(
            f"{who}: {cfg.name} is of family {cfg.family!r}; {who} covers the "
            f"transformer families ({', '.join(TRANSFORMER_FAMILIES)}) only: "
            f"{cfg.family} decodes through make_serve_step directly, "
            f"{_DIRECT_DECODE[cfg.family]}, as in the reference")


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
