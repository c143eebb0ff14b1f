"""Train, prefill, decode and sampling steps, and the dry run's stand-ins.

The port's counterpart of ``repro.launch.steps``. ``make_loss_fn``
and ``make_train_step`` train on the models' ``impl="autograd"`` route
(stock ops under autograd; the hand kernels have no backward), with the
JAX package's AdamW and schedule. ``input_specs``, ``param_structs``,
``opt_structs`` and ``cache_structs`` are ``meta`` tensors of every input
of one (arch x shape) cell (DTensors placed by the logical-axis rules
inside an ``axis_rules`` binding), and ``step_for`` the cell's step and
arguments, for the dry run (``launch/dryrun.py``). The JAX
package jits them and donates the decode cache (``donate_argnums=(1,)``).
Here ``make_prefill_step`` and ``make_decode_step`` run eagerly, the decode
step writing the new K/V and every recurrent state into the cache it is
given, in place on its device; ``CompiledDecodeStep`` is the jitted decode
step's counterpart, one CUDA graph over an engine's parameters and cache.
The paged engine's steps address a KV block pool through block tables:
``make_paged_prefill_step`` writes a prefill's cache into the pool, and
``make_paged_decode_step`` runs a window of w tokens (forward, sample,
feed back) without the host; ``CompiledPagedDecode`` is the counterpart of
the JAX package's ``jax.jit(..., donate_argnums=(1, 2))`` windows, one CUDA
graph a (bucket, window) rung, all captured when the engine is built.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.executor import CapturedGraph
from repro_torch.dtypes import as_tensor, torch_dtype
from repro_torch.models import transformer as tf
from repro_torch.configs.base import ShapeConfig
from repro_torch.models.common import (AUTOGRAD, ParamSpec, shape_structs,
                                       softmax_cross_entropy)
from repro_torch.optim.adamw import (AdamWConfig, AdamWState,
                                     adamw_init_specs, adamw_update)
from repro_torch.optim.schedules import cosine_warmup


# ---------------------------------------------------------------------------
# Input specs
# ---------------------------------------------------------------------------

def _sds(shape, dtype, axes):
    return shape_structs(ParamSpec(tuple(shape), dtype, "zeros", axes=axes))


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``meta`` stand-ins for the data inputs of one cell (the reference's
    shapes and dtypes)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        if cfg.input_kind == "tokens":
            toks = _sds((B, S), "int32", ("batch", None))
        else:   # vlm/audio: precomputed patch/frame embeddings (stub frontend)
            toks = _sds((B, S, cfg.d_model), cfg.dtype,
                        ("batch", None, "embed"))
        return {"inputs": toks,
                "targets": _sds((B, S), "int32", ("batch", None))}
    if shape.kind == "prefill":
        if cfg.input_kind == "tokens":
            toks = _sds((B, S), "int32", ("batch", None))
        else:
            toks = _sds((B, S, cfg.d_model), cfg.dtype,
                        ("batch", None, "embed"))
        return {"inputs": toks}
    # decode: one new token against a seq_len-deep cache
    if cfg.input_kind == "tokens":
        toks = _sds((B, 1), "int32", ("batch", None))
    else:
        toks = _sds((B, 1, cfg.d_model), cfg.dtype, ("batch", None, "embed"))
    return {"inputs": toks, "pos": _sds((B,), "int32", ("batch",))}


def param_structs(cfg: ModelConfig):
    return shape_structs(tf.model_specs(cfg))


def opt_structs(cfg: ModelConfig):
    return shape_structs(adamw_init_specs(tf.model_specs(cfg)))


def cache_structs(cfg: ModelConfig, shape: ShapeConfig):
    return shape_structs(tf.cache_specs(cfg, shape.global_batch,
                                        shape.seq_len))


def make_loss_fn(cfg: ModelConfig, remat: bool,
                 remat_policy: str = "full"):
    """``loss_fn(params, batch) -> (total, (loss, aux))``: the training
    forward (``impl="autograd"``) on ``batch["inputs"]`` (tokens, or a
    vlm/audio config's embeddings), the mean token NLL of
    ``batch["targets"]``, and ``total = loss + AUX_LOSS_WEIGHT * aux``
    (aux the MoE load-balance loss, 0 without experts)."""
    def loss_fn(params, batch):
        logits, _, aux = tf.forward_full(cfg, params, batch["inputs"],
                                         impl=AUTOGRAD, remat=remat,
                                         remat_policy=remat_policy)
        targets = as_tensor(batch["targets"], logits.device)
        loss = softmax_cross_entropy(logits, targets)
        return loss + tf.AUX_LOSS_WEIGHT * aux, (loss, aux)
    return loss_fn


class TrainStep:
    """The train step in its three parts, which ``__call__`` runs in
    order: ``forward`` (``make_loss_fn``'s loss on the parameters as leaves
    that require grad), ``backward`` (``torch.autograd.grad`` of the
    total) and ``update`` (``lr = cosine_warmup(opt_state.step, ...)``
    taken before the step count moves, then ``adamw_update``, which writes
    the parameters and moments in place). The parts are public so that a
    profiler can time each part of the very step a driver runs."""

    def __init__(self, cfg: ModelConfig, opt: AdamWConfig, peak_lr: float,
                 warmup: int, total_steps: int, remat: bool,
                 remat_policy: str):
        self.opt, self.peak_lr = opt, peak_lr
        self.warmup, self.total_steps = warmup, total_steps
        self.loss_fn = make_loss_fn(cfg, remat, remat_policy)

    def forward(self, params: dict, batch: dict):
        """-> (leaves, total, (loss, aux)); ``leaves`` the parameters
        detached and requiring grad, in sorted key order."""
        leaves = {k: params[k].detach().requires_grad_(True)
                  for k in sorted(params)}
        total, (loss, aux) = self.loss_fn(leaves, batch)
        return leaves, total, (loss, aux)

    def backward(self, leaves: dict, total: torch.Tensor) -> dict:
        """The gradient of ``total`` for each leaf, by key."""
        return dict(zip(leaves, torch.autograd.grad(total,
                                                    list(leaves.values()))))

    def update(self, params: dict, opt_state: AdamWState, grads: dict):
        """-> (params, opt_state, {"lr", "grad_norm", "clip_scale"})."""
        lr = cosine_warmup(opt_state.step, self.peak_lr, self.warmup,
                           self.total_steps)
        params, opt_state, gm = adamw_update(self.opt, grads, opt_state,
                                             params, lr)
        return params, opt_state, {"lr": lr, **gm}

    def __call__(self, params: dict, opt_state: AdamWState, batch: dict):
        leaves, total, (loss, aux) = self.forward(params, batch)
        grads = self.backward(leaves, total)
        params, opt_state, um = self.update(params, opt_state, grads)
        return params, opt_state, {
            "loss": loss.detach(), "aux_loss": aux.detach(),
            "total_loss": total.detach(), **um}


def make_train_step(cfg: ModelConfig, opt: AdamWConfig = AdamWConfig(),
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, remat: bool = True,
                    remat_policy: Optional[str] = None) -> TrainStep:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` (a ``TrainStep``): the gradients of ``make_loss_fn``'s
    total, then the AdamW update at ``cosine_warmup``'s lr. ``metrics``
    holds 0-d tensors: loss, aux_loss, total_loss, lr, grad_norm,
    clip_scale. ``remat_policy`` defaults to ``"full"``. The JAX package's
    ``unroll`` has no counterpart: the port's layers are always a Python
    loop."""
    return TrainStep(cfg, opt, peak_lr, warmup, total_steps, remat,
                     remat_policy or "full")


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, {"inputs": (B,S)}) -> (last-position logits
    (B,V), cache)``, the cache stacked by layer with ``tf.cache_specs``'
    keys; a vlm or audio config's inputs are (B,S,d) embeddings."""
    def prefill_step(params, batch):
        logits, cache, _ = tf.forward_full(cfg, params, batch["inputs"],
                                           want_cache=True)
        return logits[:, -1], cache
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_step(params, cache, {"inputs": (B,1), "pos": (B,)}) ->
    (logits (B,V), cache)``, the cache updated in place; a vlm or audio
    config's inputs are (B,1,d) embeddings."""
    def decode_step(params, cache, batch):
        logits, cache = tf.forward_decode(cfg, params, batch["inputs"],
                                          batch["pos"], cache)
        return logits[:, 0], cache
    return decode_step


class CompiledDecodeStep:
    """``make_decode_step(cfg)`` compiled for one engine's ``params`` and
    ``cache`` (KV rows and recurrent states): the counterpart of the JAX
    package's ``jax.jit(make_decode_step(cfg), donate_argnums=(1,))``.

    Tokens (B, 1) and positions (B,) enter through static int32 buffers on the
    cache's device (a vlm or audio config's (B, 1, d) embeddings through a
    buffer in the config's dtype). On CUDA the step is captured once, here, as
    one ``CapturedGraph`` that reads the weights and writes every cache tensor
    in place: the cache's addresses are baked in, so its owner allocates it
    once and never rebinds it (what donating it buys the JAX package). The
    warm-up run before the capture decodes token 0 at position 0 in every
    lane, so it writes row 0 of every slot's KV and every slot's recurrent
    states, as a free lane's decode does; the next prefill's splice
    overwrites them. A failed capture raises; nothing falls
    back to the eager step. On the CPU the same step runs uncaptured over
    the same static buffers.

    It is called as the eager step is, ``step(params, cache, batch) ->
    (logits (B, V), cache)``, with the very ``params`` and ``cache`` it was
    compiled for and ``batch`` values as tensors of the buffers' dtypes;
    the logits are a copy that the next call does not overwrite."""

    def __init__(self, cfg: ModelConfig, params: dict, cache: dict,
                 max_batch: int):
        dev = next(iter(cache.values())).device
        self.params, self.cache = params, cache
        self.step = make_decode_step(cfg)
        inputs = torch.zeros((max_batch, 1), dtype=torch.int32, device=dev) \
            if cfg.input_kind == "tokens" else \
            torch.zeros((max_batch, 1, cfg.d_model),
                        dtype=torch_dtype(cfg.dtype), device=dev)
        self.inputs = {
            "inputs": inputs,
            "pos": torch.zeros((max_batch,), dtype=torch.int32, device=dev)}
        self.graph = None
        if dev.type == "cuda":
            held = {**{f"params/{k}": v for k, v in params.items()},
                    **{f"cache/{k}": v for k, v in cache.items()}}
            self.graph = CapturedGraph(self._run, self.inputs, held, dev)

    def _run(self, inputs: dict, held=None) -> dict:
        logits, _ = self.step(self.params, self.cache, inputs)
        return {"logits": logits}

    def __call__(self, params: dict, cache: dict, batch: dict):
        if params is not self.params or cache is not self.cache:
            raise ValueError("the decode step was compiled for other "
                             "parameters or another cache")
        if self.graph is not None:
            return self.graph(batch)["logits"], cache
        for k, buf in self.inputs.items():
            buf.copy_(batch[k])
        return self._run(self.inputs)["logits"], cache


def make_paged_prefill_step(cfg: ModelConfig):
    """Prefill that lands its KV directly in the paged pool: the same dense
    forward as ``make_prefill_step`` (the same last-token logits, hence the
    same first sampled token), then one in-place write through the batch's
    block tables. ``paged_prefill_step(params, pool_k, pool_v, {"inputs":
    (B,S), "tables": (B,W)}) -> (last_logits (B,V), pool_k, pool_v)``; a
    vlm or audio config's inputs are (B,S,d) embeddings."""
    def paged_prefill_step(params, pool_k, pool_v, batch):
        logits, cache, _ = tf.forward_full(cfg, params, batch["inputs"],
                                           want_cache=True)
        tf.scatter_prefill_cache(pool_k, pool_v, cache["k"], cache["v"],
                                 batch["tables"])
        return logits[:, -1], pool_k, pool_v
    return paged_prefill_step


def make_paged_decode_step(cfg: ModelConfig, window: int = 1,
                           greedy: bool = True, temperature: float = 1.0):
    """Multi-token decode for the paged pool: one call advances every lane
    ``window`` tokens, running forward, sample and feed-back ``window``
    times on the device, so the host touches only (B, window) sampled ints.
    ``paged_decode_step(params, pool_k, pool_v, {"tokens": (B,), "pos":
    (B,), "tables": (lanes, W)[, "generator"]}) -> (tokens (B, window)
    int32, pool_k, pool_v)``, where ``tokens`` is each lane's last sampled
    token (written at ``pos``), ``tables`` has lanes >= B rows (the rows
    past B null, ``tf.forward_decode_paged``) and row b of the output is
    lane b's ``window`` new tokens; sampling that is not greedy draws from
    ``generator``. The window feeds its sampled tokens back as the next
    inputs, so a vlm or audio config, whose inputs are embeddings, raises
    (the JAX package's step fails on one too; the single steps,
    ``tf.forward_decode_paged`` and ``make_paged_prefill_step``, take
    embeddings)."""
    if cfg.input_kind != "tokens":
        raise NotImplementedError(
            "the paged decode window feeds sampled tokens back: it takes "
            f"token prompts, not {cfg.input_kind!r} input")

    def paged_decode_step(params, pool_k, pool_v, batch):
        tok, pos, tables = batch["tokens"], batch["pos"], batch["tables"]
        out = []
        for _ in range(window):
            logits, _, _ = tf.forward_decode_paged(
                cfg, params, tok[:, None], pos, pool_k, pool_v, tables)
            tok = sample_tokens(logits[:, 0], greedy, temperature,
                                batch.get("generator"))
            out.append(tok)
            pos = pos + 1
        return torch.stack(out, dim=1), pool_k, pool_v
    return paged_decode_step


class CompiledPagedDecode:
    """The paged decode windows compiled for one engine's ``params`` and
    pool: the counterpart of the JAX package's ``jax.jit(
    make_paged_decode_step(...), donate_argnums=(1, 2))`` executables, one
    per (bucket, window) rung in ``rungs``, every one over tables of
    ``tables_shape`` (the engine's (max_batch, max_seq / block_size)).

    On CUDA every rung is captured here, when the engine is built, as one
    ``CapturedGraph`` over static int32 buffers for tokens (bucket,),
    positions (bucket,) and tables: the window's steps, the sampling and
    ``pos + 1`` included, run inside the graph, which writes the pool in
    place at baked-in addresses (its owner never rebinds it). The static
    tables are filled with the null block before the capture's warm-up
    run, which therefore writes only the null block: a rung captured while
    sequences hold blocks (``capture``) leaves their blocks untouched. A
    JAX executable takes the params and pool as arguments and is shared by
    every engine over the same program; a graph cannot be, so each engine
    holds its own, in ``graphs``, and ``release`` drops them. Sampling
    that is not greedy draws from ``generator``, registered with each
    graph. A failed capture raises; nothing falls back to an uncaptured
    run. On the CPU every call runs ``eager``.

    It is called as ``decode(params, pool_k, pool_v, batch, window) ->
    (tokens (bucket, window), pool_k, pool_v)``, with the very params and
    pool it was compiled for and ``batch`` as int32 tensors ("tokens",
    "pos", "tables") at one of its rungs, on either device; ``captured``
    lists each rung it captured and the seconds that took."""

    def __init__(self, cfg: ModelConfig, params: dict, pool_k, pool_v,
                 rungs, tables_shape: tuple, greedy: bool = True,
                 temperature: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        self.cfg, self.params = cfg, params
        self.pool_k, self.pool_v = pool_k, pool_v
        self.device = pool_k.device
        self.null_block = pool_k.shape[1] - 1       # the pool's last block
        self.rungs = tuple(rungs)
        self.tables_shape = tuple(tables_shape)
        self.greedy, self.temperature = greedy, temperature
        self.generator = generator
        self.held = {**{f"params/{k}": v for k, v in params.items()},
                     "pool/k": pool_k, "pool/v": pool_v}
        self.graphs: dict = {}
        self.captured: list = []
        if self.device.type == "cuda":
            for bucket, window in self.rungs:
                self.capture(bucket, window)

    def eager(self, params, pool_k, pool_v, batch, window: int):
        """One window on stock ops, uncaptured (the CPU path, and the card's
        reference for a replay)."""
        step = make_paged_decode_step(self.cfg, window, self.greedy,
                                      self.temperature)
        return step(params, pool_k, pool_v,
                    {**batch, "generator": self.generator})

    def capture(self, bucket: int, window: int) -> CapturedGraph:
        """Capture the rung's graph now, in place of any it had."""
        dev = self.device
        static = {
            "tokens": torch.zeros((bucket,), dtype=torch.int32, device=dev),
            "pos": torch.zeros((bucket,), dtype=torch.int32, device=dev),
            "tables": torch.full(self.tables_shape, self.null_block,
                                 dtype=torch.int32, device=dev)}

        def run(inputs, held=None):
            toks, _, _ = self.eager(self.params, self.pool_k, self.pool_v,
                                    inputs, window)
            return {"tokens": toks}
        graph = CapturedGraph(run, static, self.held, dev,
                              None if self.greedy else self.generator)
        self.graphs[(bucket, window)] = graph
        self.captured.append({"rung": [bucket, window],
                              "capture_s": graph.capture_s})
        return graph

    def __call__(self, params, pool_k, pool_v, batch, window: int):
        if params is not self.params or pool_k is not self.pool_k \
                or pool_v is not self.pool_v:
            raise ValueError("the decode windows were compiled for other "
                             "parameters or another pool")
        rung = (batch["tokens"].shape[0], window)
        if rung not in self.rungs \
                or tuple(batch["tables"].shape) != self.tables_shape:
            raise ValueError(f"no decode window compiled for (bucket, "
                             f"window) {rung} over tables "
                             f"{tuple(batch['tables'].shape)}")
        if self.device.type != "cuda":
            return self.eager(params, pool_k, pool_v, batch, window)
        return self.graphs[rung](batch)["tokens"], pool_k, pool_v

    def release(self) -> None:
        """Drop the captured windows (with them their memory pools and
        their hold on the params and pool)."""
        self.graphs.clear()


def sample_tokens(logits: torch.Tensor, greedy: bool, temperature: float,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Next-token pick: (B, V) logits -> (B,) int32. Greedy is the first
    maximal index, as ``jnp.argmax``'s. Otherwise one draw per row from
    ``softmax(logits / T)`` with ``generator`` (on the logits' device): the
    distribution of the JAX package's ``jax.random.categorical``, not its
    tokens. The draw is the exponential race ``argmax(p / q)``, q ~ Exp(1)
    (the algorithm of ``torch.multinomial``'s one-sample path), with no
    host read, so it runs inside a CUDA graph."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("temperature sampling requires a torch.Generator")
    t = torch.full((), max(float(temperature), 1e-6), dtype=torch.float32,
                   device=logits.device)
    probs = torch.softmax(logits.float() / t, dim=-1)
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1).to(torch.int32)


def step_for(cfg: ModelConfig, shape: ShapeConfig):
    """``(fn, args, donate)`` of one dry-run cell: train steps on the
    training route (``impl="autograd"``), prefill and decode on the served
    route (the hand kernels), so the dry run counts the kernels the port
    runs. ``donate`` names the arguments the step writes in place (the
    train step's params and moments, the decode step's cache)."""
    if shape.kind == "train":
        fn = make_train_step(cfg)
        args = (param_structs(cfg), opt_structs(cfg), input_specs(cfg, shape))
        donate = (0, 1)
    elif shape.kind == "prefill":
        fn = make_prefill_step(cfg)
        args = (param_structs(cfg), input_specs(cfg, shape))
        donate = ()
    else:
        fn = make_decode_step(cfg)
        args = (param_structs(cfg), cache_structs(cfg, shape),
                input_specs(cfg, shape))
        donate = (1,)
    return fn, args, donate
