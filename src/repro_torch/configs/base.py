"""Model configurations: the port's copy of ``repro.configs.base``.

Every architecture is a frozen ``ModelConfig``; input shapes are
``ShapeConfig``s. Reduced ("smoke") variants
are derived mechanically, so the CPU tests run the same code path as the
full configurations. Field names, defaults and ``smoke()`` match the JAX
package exactly: both packages must compile the same configuration to the
same RCB program bytes.
"""
from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (family-polymorphic superset)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attention-free)
    num_kv_heads: int
    head_dim: int
    d_ff: int                        # dense FFN (or per-expert FFN for MoE)
    vocab_size: int

    # --- attention flavour -------------------------------------------------
    attention: str = "full"          # full | sliding | none
    sliding_window: int = 0          # used when attention == "sliding"
    qk_norm: bool = False            # qwen3
    qkv_bias: bool = False           # qwen2
    rope_theta: float = 10_000.0
    use_rope: bool = True

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    moe_dense_residual: bool = False  # arctic: dense MLP in parallel w/ MoE
    d_ff_dense: int = 0               # width of the arctic dense residual MLP

    # --- SSM / recurrent ---------------------------------------------------
    ssm_state: int = 0               # mamba state size (hymba)
    rwkv_head_dim: int = 64          # rwkv6 head size

    # --- modality ----------------------------------------------------------
    input_kind: str = "tokens"       # tokens | embeddings (vlm/audio stubs)

    # --- misc --------------------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    subquadratic: bool = False       # may run long_500k

    # ------------------------------------------------------------------ api
    @property
    def attn_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, v = self.d_model, self.vocab_size
        n = v * d if self.input_kind == "tokens" else 0   # token embedding
        if not self.tie_embeddings:
            n += v * d                                    # lm head
        n += d                                        # final norm
        per_layer = 2 * d                             # two RMSNorm scales
        if self.family == "ssm":                      # rwkv6 time-mix + channel-mix
            heads = d // self.rwkv_head_dim
            per_layer += 4 * d * d                    # r,k,v,g projections
            per_layer += d * d                        # output proj
            per_layer += 2 * d * 32 + 6 * d * 32      # lora decks (w / mix)
            per_layer += 2 * d + heads * self.rwkv_head_dim  # w0, u, ln params
            per_layer += d * self.d_ff + self.d_ff * d + d * d  # channel mix
        else:
            ad, kd = self.attn_dim, self.kv_dim
            per_layer += d * ad + 2 * d * kd + ad * d  # q,k,v,o
            if self.qkv_bias:
                per_layer += ad + 2 * kd
            if self.qk_norm:
                per_layer += 2 * self.head_dim
            if self.family == "hybrid":
                di, s = self.d_model, self.ssm_state
                per_layer += d * 2 * di + di * d       # in/out proj
                per_layer += di * (2 * s + 1) + di * s + di  # B,C,dt proj; A; D
            if self.num_experts > 0:
                per_layer += d * self.num_experts      # router
                per_layer += self.num_experts * 3 * d * self.d_ff
                if self.moe_dense_residual:
                    per_layer += 3 * d * self.d_ff_dense
            else:
                per_layer += 3 * d * self.d_ff         # SwiGLU
        return n + self.num_layers * per_layer

    def active_param_count(self) -> int:
        """Active params per token (MoE counts only routed experts)."""
        if self.num_experts == 0:
            return self.param_count()
        full = self.param_count()
        inactive = (self.num_experts - self.experts_per_token) * \
            3 * self.d_model * self.d_ff * self.num_layers
        return full - inactive

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=2,
            d_model=64,
            num_heads=max(1, min(4, self.num_heads)) if self.num_heads else 0,
            num_kv_heads=_smoke_kv(self),
            head_dim=16 if self.num_heads else self.head_dim,
            d_ff=128,
            d_ff_dense=64 if self.moe_dense_residual else 0,
            vocab_size=256,
            num_experts=min(4, self.num_experts),
            experts_per_token=min(2, self.experts_per_token),
            # dropless in smoke tests: capacity covers worst-case routing so
            # decode is exactly consistent with full forward (capacity
            # dropping is seq-length-dependent by construction)
            moe_capacity_factor=float(min(4, self.num_experts) or 1),
            sliding_window=min(16, self.sliding_window) if self.sliding_window else 0,
            ssm_state=min(4, self.ssm_state) if self.ssm_state else 0,
            rwkv_head_dim=16,
            dtype="float32",
        )


def _smoke_kv(cfg: ModelConfig) -> int:
    if cfg.num_heads == 0:
        return 0
    q = max(1, min(4, cfg.num_heads))
    if cfg.num_kv_heads == cfg.num_heads:       # MHA stays MHA
        return q
    return max(1, min(2, cfg.num_kv_heads))     # GQA stays grouped


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    def smoke(self) -> "ShapeConfig":
        return dataclasses.replace(
            self, name=self.name + "-smoke",
            seq_len=min(32, self.seq_len), global_batch=min(4, self.global_batch))


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeConfig("long_500k", "decode", 524_288, 1),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """Shape cells for an architecture (long_500k only for sub-quadratic)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        names.append("long_500k")
    return names


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate config {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from repro_torch import configs as _pkg  # ensure arch modules imported
    _pkg.load_all()
    if name.endswith("-smoke"):
        return _REGISTRY[name[: -len("-smoke")]].smoke()
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from repro_torch import configs as _pkg
    _pkg.load_all()
    return sorted(_REGISTRY)
