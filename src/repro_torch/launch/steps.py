"""Prefill, decode and sampling steps of the LM serving engine.

The port's counterpart of ``repro.launch.steps``' serve steps. The JAX
package jits them and donates the decode cache (``donate_argnums=(1,)``).
Here ``make_prefill_step`` and ``make_decode_step`` run eagerly, the decode
step writing the new K/V and every recurrent state into the cache it is
given, in place on its device; ``CompiledDecodeStep`` is the jitted decode
step's counterpart, one CUDA graph over an engine's parameters and cache.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.executor import CapturedGraph
from repro_torch.models import transformer as tf


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, {"inputs": (B,S)}) -> (last-position logits
    (B,V), cache)``, the cache stacked by layer with ``tf.cache_specs``'
    keys."""
    def prefill_step(params, batch):
        logits, cache = tf.forward_full(cfg, params, batch["inputs"],
                                        want_cache=True)
        return logits[:, -1], cache
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_step(params, cache, {"inputs": (B,1), "pos": (B,)}) ->
    (logits (B,V), cache)``, the cache updated in place."""
    def decode_step(params, cache, batch):
        logits, cache = tf.forward_decode(cfg, params, batch["inputs"],
                                          batch["pos"], cache)
        return logits[:, 0], cache
    return decode_step


class CompiledDecodeStep:
    """``make_decode_step(cfg)`` compiled for one engine's ``params`` and
    ``cache`` (KV rows and recurrent states): the counterpart of the JAX
    package's ``jax.jit(make_decode_step(cfg), donate_argnums=(1,))``.

    Tokens (B, 1) and positions (B,) enter through static int32 buffers on
    the cache's device. On CUDA the step is captured once, here, as one
    ``CapturedGraph`` that reads the weights and writes every cache tensor
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
    compiled for and ``batch`` values as int32 tensors; the logits are a
    copy that the next call does not overwrite."""

    def __init__(self, cfg: ModelConfig, params: dict, cache: dict,
                 max_batch: int):
        dev = next(iter(cache.values())).device
        self.params, self.cache = params, cache
        self.step = make_decode_step(cfg)
        self.inputs = {
            "inputs": torch.zeros((max_batch, 1), dtype=torch.int32,
                                  device=dev),
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


def sample_tokens(logits: torch.Tensor, greedy: bool, temperature: float,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Next-token pick: (B, V) logits -> (B,) int32. Greedy is the first
    maximal index, as ``jnp.argmax``'s. Otherwise one draw per row from
    ``softmax(logits / T)`` with ``generator`` (on the logits' device): the
    distribution of the JAX package's ``jax.random.categorical``, not its
    tokens."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("temperature sampling requires a torch.Generator")
    t = torch.full((), max(float(temperature), 1e-6), dtype=torch.float32,
                   device=logits.device)
    probs = torch.softmax(logits.float() / t, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
