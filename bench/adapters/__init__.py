"""One module a ``model_type``: how a configuration file (the model's
published ``config.json`` keys) becomes the port's ``ModelConfig``, and
which leaves of the port's parameter tree each layer of the plain
reference reads.

An adapter module defines

* ``port_config(hf: dict) -> ModelConfig``
* ``layer_weights(params, cfg, i) -> dict``: layer ``i``'s weights under
  the reference's names (views of the benchmark's tensors, no copies):
  ``ln1``, ``ln2``, the FFN's (``common_weights``) and the mixer's, an
  attention layer's or a Mamba layer's (``reference/model.py``).

Adding a model family is adding ``adapters/<model_type>.py``.
"""
from __future__ import annotations

import importlib
from typing import Dict


def load(model_type: str):
    return importlib.import_module(f"bench.adapters.{model_type}")


def dtype_of(hf: Dict) -> str:
    """The type the model is served in (``torch_dtype``; bfloat16 unless
    given)."""
    return hf.get("torch_dtype", "bfloat16")


def _layer_tree(params, cfg, i: int) -> Dict:
    """Layer ``i``'s leaves in the port's tree: an unstacked prefix
    layer's own dict, or group ``g`` of a stacked position."""
    from repro_torch.models.transformer import _prefix_count

    npre = _prefix_count(cfg)
    if i < npre:
        return params["prefix"][i]
    period = len(params["stack"])
    g, j = divmod(i - npre, period)

    def at(tree):
        if isinstance(tree, dict):
            return {k: at(v) for k, v in tree.items()}
        return tree[g]

    return at(params["stack"][j])


def common_weights(params, cfg, i: int) -> Dict:
    """The reference's names for the norms and FFN of layer ``i``, and
    its mixer's leaves in the port's tree under ``attn`` or, on a Mamba
    layer, ``mamba``, for the adapter to name."""
    blk = _layer_tree(params, cfg, i)
    w = {"ln1": blk["ln1"], "ln2": blk["ln2"]}
    if "ffn_moe" in blk:
        moe = blk["ffn_moe"]
        w.update(router=moe["router"], experts_gate=moe["experts"]["wi_gate"],
                 experts_up=moe["experts"]["wi_up"],
                 experts_down=moe["experts"]["wo"])
        if "shared" in moe:
            w.update(shared_gate=moe["shared"]["wi_gate"],
                     shared_up=moe["shared"]["wi_up"],
                     shared_down=moe["shared"]["wo"])
    else:
        w.update(dense_gate=blk["ffn"]["wi_gate"], dense_up=blk["ffn"]["wi_up"],
                 dense_down=blk["ffn"]["wo"])
    mixer = "mamba" if "mamba" in blk else "attn"
    w[mixer] = blk[mixer]
    return w
