"""Parameter key flattening (the port's copy of what
``repro.serving.engine.pack_params_image`` takes from
``repro.checkpoint.ckpt._flatten``): each entry of a parameter dict is
keyed as ``jax.tree_util.keystr`` keys a dict entry, ``"['name']"``, in
sorted order, so a RIMFS image packed from the same parameters has the
same bytes in both packages."""
from __future__ import annotations


def flatten(params: dict) -> dict:
    """{"['name']": leaf} in the order ``jax.tree_util`` flattens a dict."""
    return {f"[{k!r}]": params[k] for k in sorted(params)}
