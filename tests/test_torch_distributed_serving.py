"""The serving path on a mesh: RBL binds the LM service program with
placements resolved from its TensorDescs, the parameters are DTensors
placed by ``param_shardings`` under the "decode" rules, and the program's
prefill and decode artifacts run on them over 8 ``gloo`` ranks (2 x 4).
The decode logits are held against the port's unsharded run (1e-5) and
the JAX package's (5e-4)."""
import dataclasses

import numpy as np

from torch_dist_util import run_ranks

B, S = 2, 16

_SERVE = """
import dataclasses
from repro_torch.configs import get_config
from repro_torch.core import rctc
from repro_torch.core.rbl import bind, resolve_shardings
from repro_torch.distributed.sharding import axis_rules, place, sharding_for
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import transformer as tf
from repro_torch.models.common import param_shardings, place_params

B, S = 2, 16
cfg = dataclasses.replace(get_config("qwen2-1.5b-smoke"), d_model=64,
                          num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
                          vocab_size=256)
params = tf.init_params(cfg, 0, device="cpu")
toks = torch.tensor(np.random.RandomState(0).randint(0, 256, (B, S)),
                    dtype=torch.int32)
cspecs = tf.cache_specs(cfg, B, S + 8)
pos = torch.full((B,), S, dtype=torch.int32)


def serve(p, shardings=None):
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    prog = rctc.compile_lm_service(cfg, B, S, prefill, decode)
    sh = resolve_shardings(prog)
    bound = bind(prog, inputs={})
    assert "tokens" in bound.missing_inputs
    t = place(toks, sharding_for(toks.shape, ("batch", None)))
    logits, pc = prog.artifacts["prefill"](p, {"inputs": t})
    full = lambda x: x.full_tensor() if hasattr(x, "full_tensor") else x
    cache = {k: torch.zeros(s.shape, dtype=pc[k].dtype)
             for k, s in cspecs.items()}
    for k in cache:
        cache[k][:, :, :S] = full(pc[k])
    if shardings is not None:
        cache = place_params(cache, param_shardings(cspecs))
    nxt = torch.argmax(full(logits), -1)[:, None].to(torch.int32)
    batch = {"inputs": place(nxt, sharding_for(nxt.shape, ("batch", None))),
             "pos": place(pos, sharding_for(pos.shape, ("batch",)))}
    l2, cache = prog.artifacts["decode"](p, cache, batch)
    return sh, full(logits), full(l2), {k: full(v) for k, v in cache.items()}


_, l1_plain, l2_plain, c_plain = serve(params)
mesh = make_test_mesh((2, 4))
with axis_rules(mesh, "decode"):
    shardings = param_shardings(tf.model_specs(cfg))
    ps = place_params(params, shardings)
    sh, l1, l2, c = serve(ps, shardings)
    sharded = sum(any(pl.is_shard() for pl in t.placements)
                  for t in ps.values())
if rank == 0:
    np.savez(out, l1=l1.numpy(), l2=l2.numpy(), l1_plain=l1_plain.numpy(),
             l2_plain=l2_plain.numpy(), sharded=sharded,
             tokens_sharding=np.int32(sh["tokens"] is not None),
             cache_k=c["k"].numpy(), cache_k_plain=c_plain["k"].numpy(),
             **{"w_" + k: v.float().numpy() for k, v in params.items()})
"""


def _jax_logits(out: dict):
    """The same prefill and decode in the JAX package, unsharded, on the
    port's weights."""
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.launch.steps import make_decode_step, make_prefill_step
    from repro.models import transformer as jtf
    from repro.models.common import init_params
    import jax
    cfg = dataclasses.replace(get_config("qwen2-1.5b-smoke"), d_model=64,
                              num_heads=4, num_kv_heads=4, head_dim=16,
                              d_ff=128, vocab_size=256)
    params = {k[2:]: jnp.asarray(v) for k, v in out.items()
              if k.startswith("w_")}
    toks = jnp.asarray(np.random.RandomState(0).randint(0, 256, (B, S)),
                       jnp.int32)
    logits, pc = jax.jit(make_prefill_step(cfg))(params, {"inputs": toks})
    cache = init_params(jax.random.PRNGKey(1),
                        jtf.cache_specs(cfg, B, S + 8))
    cache = dict(cache)
    cache["k"] = cache["k"].at[:, :, :S].set(pc["k"].astype(cache["k"].dtype))
    cache["v"] = cache["v"].at[:, :, :S].set(pc["v"].astype(cache["v"].dtype))
    nxt = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    l2, _ = jax.jit(make_decode_step(cfg))(
        params, cache, {"inputs": nxt, "pos": jnp.full((B,), S, jnp.int32)})
    return np.asarray(logits), np.asarray(l2)


def test_sharded_lm_service_via_rcb(tmp_path):
    out = run_ranks(_SERVE, tmp_path, timeout=180)
    assert int(out["tokens_sharding"]) == 1       # batch-sharded input
    assert int(out["sharded"]) > 0
    assert out["l2"].shape == (B, 256) and np.isfinite(out["l2"]).all()
    np.testing.assert_allclose(out["l1"], out["l1_plain"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["l2"], out["l2_plain"], rtol=0, atol=1e-5)
    # the decode wrote its row into the sharded cache in place
    np.testing.assert_allclose(out["cache_k"], out["cache_k_plain"], rtol=0,
                               atol=1e-5)
    assert np.abs(out["cache_k"][:, :, S]).max() > 0
    j1, j2 = _jax_logits(out)
    np.testing.assert_allclose(out["l1"], j1, rtol=0, atol=5e-4)
    np.testing.assert_allclose(out["l2"], j2, rtol=0, atol=5e-4)
