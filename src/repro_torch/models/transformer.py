"""Parameter layout, initialization and input embedding of the LM families
ported so far (dense; hybrid: attention + Mamba + SwiGLU; ssm: RWKV-6).

The port's counterpart of the parts of ``repro.models.transformer`` and
``repro.models.common`` that the per-layer RCB lowering needs: the stacked
parameter specs (leading ``num_layers`` dim on block entries), their
initialization from a seed on a device, ``split_params``, ``embed_inputs``,
and ``params_from_jax`` to carry the JAX package's parameters across.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.dtypes import as_tensor
from repro_torch.models.common import ParamSpec, draw_param
from repro_torch.models.mamba import mamba_specs
from repro_torch.models.rwkv6 import rwkv_specs

PORTED_FAMILIES = ("dense", "hybrid", "ssm")


def check_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES or cfg.num_experts:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to PyTorch yet (dense, "
            f"hybrid and ssm only, no experts)")


def model_specs(cfg: ModelConfig) -> dict:
    """Stacked parameter specs (names and shapes as in
    ``repro.models.transformer.model_specs``): the norms, embedding and
    head, then attention and the SwiGLU MLP, plus the Mamba branch in the
    hybrid family, or the RWKV-6 time and channel mixes in the ssm one."""
    check_ported(cfg)
    L, d, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    dt = cfg.dtype
    specs = {
        "ln1": ParamSpec((L, d), dt, "ones"),
        "ln2": ParamSpec((L, d), dt, "ones"),
        "final_norm": ParamSpec((d,), dt, "ones"),
    }
    if cfg.input_kind == "tokens":
        specs["embed"] = ParamSpec((V, d), dt, "embed")
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, V), dt)
    if cfg.family == "ssm":
        specs.update(rwkv_specs(cfg))
        return specs
    H, Hkv, D, F = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    specs.update({
        "wq": ParamSpec((L, d, H, D), dt),
        "wk": ParamSpec((L, d, Hkv, D), dt),
        "wv": ParamSpec((L, d, Hkv, D), dt),
        "wo": ParamSpec((L, H, D, d), dt),
        "mlp_wi_gate": ParamSpec((L, d, F), dt),
        "mlp_wi_up": ParamSpec((L, d, F), dt),
        "mlp_wo": ParamSpec((L, F, d), dt),
    })
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((L, H, D), dt, "zeros")
        specs["bk"] = ParamSpec((L, Hkv, D), dt, "zeros")
        specs["bv"] = ParamSpec((L, Hkv, D), dt, "zeros")
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((L, D), dt, "ones")
        specs["k_norm"] = ParamSpec((L, D), dt, "ones")
    if cfg.family == "hybrid":
        specs.update(mamba_specs(cfg))
    return specs


def init_params(cfg: ModelConfig, seed: int, device="cuda") -> dict:
    """Draw parameters from ``seed`` with a ``torch.Generator`` on
    ``device``, one spec after another in name order (``draw_param`` has
    the init kinds)."""
    dev = device_mod.resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    specs = model_specs(cfg)
    return {name: draw_param(specs[name], gen, dev) for name in sorted(specs)}


def params_from_jax(np_params: dict, device="cuda") -> dict:
    """The JAX package's stacked parameter dict (as numpy arrays, bf16 as
    ml_dtypes arrays) as the port's tensors on ``device``, bit for bit."""
    dev = device_mod.resolve(device)
    return {k: as_tensor(np.asarray(v), dev) for k, v in np_params.items()}


_BLOCK_KEYS_GLOBAL = ("embed", "lm_head", "final_norm")


def split_params(params: dict):
    blocks = {k: v for k, v in params.items() if k not in _BLOCK_KEYS_GLOBAL}
    glob = {k: v for k, v in params.items() if k in _BLOCK_KEYS_GLOBAL}
    return glob, blocks


def embed_inputs(cfg: ModelConfig, glob: dict, tokens) -> torch.Tensor:
    """tokens (B,S) -> hidden (B,S,d) on the embedding's device."""
    emb = glob["embed"]
    return emb[as_tensor(tokens, emb.device).long()]
