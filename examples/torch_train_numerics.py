"""The numerics behind the port's training tolerances, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python examples/torch_train_numerics.py

Prints three things, each for the JAX package and the PyTorch port:

1. ``curve``: the 20-step loss curve of ``make_train_step`` on
   ``SyntheticLM`` (B 4 x S 32, warm-up 5) for qwen2-1.5b and
   moonshot-v1-16b-a3b smoke at peak lr 3e-3 and 1e-3: the largest
   relative gap between the JAX package's jitted and eager steps (the same
   function), and between the port and the jitted JAX step, both from the
   same weights.
2. ``init_grad_norm``: the gradient norm of one step at initialization
   against depth (qwen2-1.5B's width, vocabulary 4096, d_ff 1024, fp32,
   2 to 28 layers). ``init_params`` takes wq/wk/wv's fan-in from the heads
   axis, so q.k is large, each softmax nearly one-hot, and the norm grows
   with every layer.
3. ``attention_fp32_vs_fp64``: one attention layer of qwen2-1.5B at full
   width on its init, the port's fp32 gradients against the same in fp64
   (each leaf's max error over its max): at this init the softmax's
   backward cancels and fp32 keeps almost none of it.

It imports JAX and so runs here only, not on the card.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.models.common import init_params as jax_init_params  # noqa: E402
from repro.optim.adamw import adamw_init_specs, global_norm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402


def curves(name: str, lr: float) -> dict:
    jcfg, cfg = jax_get_config(name), get_config(name)
    batches = [SyntheticLM(cfg.vocab_size, 32, 4).global_batch_at(i)
               for i in range(20)]
    kw = dict(peak_lr=lr, warmup=5, total_steps=300)
    specs = jax_tf.model_specs(jcfg)
    p0 = jax_init_params(jax.random.PRNGKey(0), specs)
    o0 = jax_init_params(jax.random.PRNGKey(1), adamw_init_specs(specs))
    out = {}
    for mode in ("jit", "eager"):
        fn = jax_steps.make_train_step(jcfg, **kw)
        fn = jax.jit(fn) if mode == "jit" else fn
        p, o, losses = p0, o0, []
        for b in batches:
            p, o, m = fn(p, o, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
        out[mode] = np.array(losses)
    params = tf.params_from_jax({k: np.asarray(v) for k, v in p0.items()},
                                device="cpu")
    opt, step, losses = adamw_init(params), steps.make_train_step(cfg, **kw), []
    for b in batches:
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))

    def gap(a, b):
        return float(np.max(np.abs(a - b) / np.abs(b)))
    return {"model": name, "lr": lr,
            "jax_eager_vs_jit": gap(out["eager"], out["jit"]),
            "port_vs_jax_jit": gap(np.array(losses), out["jit"])}


def init_grad_norm(layers: int) -> dict:
    jcfg = dataclasses.replace(jax_get_config("qwen2-1.5b"),
                               num_layers=layers, dtype="float32",
                               vocab_size=4096, d_ff=1024)
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=layers,
                              dtype="float32", vocab_size=4096, d_ff=1024)
    batch = SyntheticLM(cfg.vocab_size, 32, 2).global_batch_at(0)
    jp = jax_init_params(jax.random.PRNGKey(0), jax_tf.model_specs(jcfg))
    (_, _), g = jax.jit(jax.value_and_grad(
        jax_steps.make_loss_fn(jcfg, False, False), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = tf.init_params(cfg, 0, device="cpu")
    names = sorted(params)
    leaves = [params[k].requires_grad_(True) for k in names]
    total, _ = steps.make_loss_fn(cfg, False)(dict(zip(names, leaves)),
                                               batch)
    grads = torch.autograd.grad(total, leaves)
    return {"layers": layers, "jax": float(global_norm(g)),
            "port": float(torch.sqrt(sum(torch.sum(x.double() ** 2)
                                         for x in grads)))}


def attention_fp32_vs_fp64() -> dict:
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), num_layers=1,
                              dtype="float32")
    _, blocks = tf.split_params(tf.init_params(cfg, 0, device="cpu"))
    p0 = {k: blocks[k][0] for k in ("wq", "wk", "wv", "wo", "bq", "bk",
                                     "bv")}
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 64, cfg.d_model), generator=gen)
    w = torch.randn((2, 64, cfg.d_model), generator=gen)
    pos = torch.arange(64, dtype=torch.int32)[None].expand(2, 64)

    def grads(dt):
        xs = x.to(dt).requires_grad_(True)
        ps = {k: v.to(dt).requires_grad_(True) for k, v in p0.items()}
        y = attn.full_attention(cfg, ps, xs, pos, impl="autograd")
        names = sorted(ps)
        g = torch.autograd.grad((y * w.to(dt)).sum(),
                                [xs] + [ps[n] for n in names])
        return dict(zip(["x"] + names, g))
    got = grads(torch.float32)
    cast = torch.Tensor.float          # the port's fp32 casts, taken to fp64
    torch.Tensor.float = torch.Tensor.double
    try:
        want = grads(torch.float64)
    finally:
        torch.Tensor.float = cast
    return {k: float((got[k].double() - want[k]).abs().max()
                     / want[k].abs().max()) for k in want}


def main() -> None:
    for name in ("qwen2-1.5b-smoke", "moonshot-v1-16b-a3b-smoke"):
        for lr in (3e-3, 1e-3):
            print(json.dumps({"curve": curves(name, lr)}), flush=True)
    for layers in (2, 8, 16, 28):
        print(json.dumps({"init_grad_norm": init_grad_norm(layers)}),
              flush=True)
    print(json.dumps({"attention_fp32_vs_fp64": attention_fp32_vs_fp64()}))


if __name__ == "__main__":
    main()
