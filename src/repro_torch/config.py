"""Configuration system for the PyTorch port.

A copy of the reference package's ``repro.config`` (the port imports
nothing of ``repro``): every architecture is a frozen ``ModelConfig``,
registered into a global registry so launchers select it with
``--arch <id>``.  ``reduced_config`` gives the smoke variant that keeps
the family wiring and shrinks width, depth and vocabulary.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Optional, Tuple


@dataclass(frozen=True)
class AttnConfig:
    """Attention flavour for a block.

    kind: "full" (causal), "local" (sliding window causal), "mla"
    (DeepSeek-style multi-head latent attention with compressed KV).
    """

    kind: str = "full"
    window: int = 1024            # sliding window (kind == "local")
    rope_base: float = 10_000.0
    rope_base_local: float = 10_000.0
    kv_lora_rank: int = 512       # MLA: compressed KV dim
    qk_rope_dim: int = 64         # MLA: rope sub-dim carried uncompressed
    qk_nope_dim: int = 128        # MLA: non-rope head dim
    v_head_dim: int = 128         # MLA: value head dim
    q_lora_rank: int = 0          # MLA: 0 = full-rank Q projection
    softmax_scale: Optional[float] = None


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 16
    num_shared_experts: int = 0
    top_k: int = 1
    d_ff_expert: int = 8192
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2
    num_heads: int = 4
    dt_rank: int = 0
    chunk_size: int = 128
    slstm_proj_factor: float = 4.0 / 3.0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 → d_model // num_heads
    block_pattern: Tuple[str, ...] = ("attn",)
    attn: AttnConfig = field(default_factory=AttnConfig)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: Optional[str] = None
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: str = "dots"
    optimizer_state_dtype: str = "float32"
    grad_accum: int = 1
    attn_chunk: int = 512         # chunked attention q/kv chunk (plain path)
    scan_group: int = 0
    subquadratic: bool = False
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def layer_pattern(self) -> Tuple[str, ...]:
        """block_pattern tiled to num_layers."""
        p = self.block_pattern
        reps = -(-self.num_layers // len(p))
        return (p * reps)[: self.num_layers]

    @property
    def group_size(self) -> int:
        g = self.scan_group or len(self.block_pattern)
        assert self.num_layers % g == 0, (self.name, self.num_layers, g)
        return g

    def param_count(self) -> int:
        """Analytic parameter count of the port's parameterization."""
        from repro_torch.models.model import count_params  # avoids a cycle
        return count_params(self)


_REGISTRY: Dict[str, ModelConfig] = {}
_REDUCERS: Dict[str, Callable[[ModelConfig], ModelConfig]] = {}


def register(cfg: ModelConfig,
             reducer: Optional[Callable[[ModelConfig], ModelConfig]] = None
             ) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch config {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    if reducer is not None:
        _REDUCERS[cfg.name] = reducer
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


def reduced_config(name_or_cfg) -> ModelConfig:
    """Smoke-test variant: same family wiring, tiny dims."""
    cfg = name_or_cfg if isinstance(name_or_cfg, ModelConfig) \
        else get_config(name_or_cfg)
    if cfg.name in _REDUCERS:
        return _REDUCERS[cfg.name](cfg)
    return default_reducer(cfg)


def default_reducer(cfg: ModelConfig) -> ModelConfig:
    n_heads = min(cfg.num_heads, 4)
    n_kv = max(1, min(cfg.num_kv_heads, n_heads))
    head_dim = 16
    d_model = n_heads * head_dim
    moe = cfg.moe
    if moe is not None:
        moe = replace(
            moe,
            num_experts=min(moe.num_experts, 8),
            top_k=min(moe.top_k, 2),
            d_ff_expert=32,
            d_ff_shared=32 if moe.num_shared_experts else 0,
        )
    ssm = cfg.ssm
    if ssm is not None:
        ssm = replace(ssm, state_dim=min(ssm.state_dim, 8),
                      num_heads=min(ssm.num_heads, 2), chunk_size=16)
    pat = cfg.block_pattern
    num_layers = len(pat) if len(pat) > 1 else 2
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=num_layers,
        d_model=d_model,
        num_heads=n_heads,
        num_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=4 * d_model if cfg.d_ff else 0,
        vocab_size=256,
        moe=moe,
        ssm=ssm,
        attn=replace(cfg.attn, window=32, kv_lora_rank=16, qk_rope_dim=8,
                     qk_nope_dim=head_dim, v_head_dim=head_dim),
        scan_group=0,
        remat="none",
        grad_accum=1,
        attn_chunk=32,
    )


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if not _LOADED:
        _LOADED = True
        from repro_torch import configs  # noqa: F401  (registers everything)
