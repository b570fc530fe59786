"""Carry the reference's weights into the port.

``params_from_numpy`` takes the JAX package's param pytree with its leaves
turned into numpy arrays (``jax.tree.map(np.asarray, params)``) and returns
the port's params: the same tree, as torch tensors on ``device``, each of
its leaf's dtype (``transformer.param_dtype``: the config's param dtype,
except the mamba leaves the reference keeps in f32). Both packages then
compute on the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.layers import Params


def params_from_numpy(tree, cfg: ModelConfig, device="cuda") -> Params:
    dev = resolve_device(device)
    expected = transformer.param_shapes(cfg)

    def convert(want, got, path):
        if isinstance(want, dict):
            if not isinstance(got, dict) or set(got) != set(want):
                raise ValueError(f"{'/'.join(path)}: keys {sorted(got)} != "
                                 f"{sorted(want)}")
            return {k: convert(want[k], got[k], path + (k,)) for k in want}
        if isinstance(want, list):
            if not isinstance(got, (list, tuple)) or len(got) != len(want):
                raise ValueError(f"{'/'.join(path)}: expected a list of "
                                 f"{len(want)}")
            return [convert(w, g, path + (str(i),))
                    for i, (w, g) in enumerate(zip(want, got))]
        # bf16 leaves arrive as ml_dtypes arrays, which torch cannot read
        a = np.array(got, dtype=np.float32)          # a writable copy
        if a.shape != tuple(want):
            raise ValueError(f"{'/'.join(path)}: shape {a.shape} != {want}")
        return torch.from_numpy(a).to(
            dev, transformer.param_dtype(cfg, path[-1]))

    return convert(expected, tree, ())
