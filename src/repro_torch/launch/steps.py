"""Prefill, decode and sampling steps of the LM serving engine.

The port's counterpart of ``repro.launch.steps``' serve steps. The JAX
package jits them and donates the decode cache (``donate_argnums=(1,)``);
here they run eagerly and the decode step writes the new K/V into the
cache it is given, in place on its device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, {"inputs": (B,S)}) -> (last-position logits
    (B,V), cache (L,B,S,Hkv,D) each of k and v)``."""
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
