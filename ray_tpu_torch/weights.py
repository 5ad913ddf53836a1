"""Parameters from numpy: the bridge from the JAX package's trees.

A JAX parameter tree with its leaves as numpy arrays (for example
`jax.tree.map(np.asarray, params)`) becomes the port's tree of tensors
with the same keys and shapes, so both packages compute the same model.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import resolve_device
from .models.transformer import TransformerConfig, param_shapes


def _tensor(arr, device) -> torch.Tensor:
    a = np.array(arr)  # a writable copy the tensor may own
    if a.dtype.name == "bfloat16":
        # numpy knows bfloat16 only through ml_dtypes; torch reads the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Dict[str, Any], cfg: TransformerConfig,
                      device=None) -> Dict[str, Any]:
    """The port's parameter tree from a tree of numpy arrays in the JAX
    layout. Keys and shapes must match `cfg` exactly; dtypes are kept."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg)

    def convert(sub, want, path):
        if isinstance(want, dict):
            if not isinstance(sub, dict) or set(sub) != set(want):
                got = sorted(sub) if isinstance(sub, dict) else type(sub).__name__
                raise ValueError(f"{path or 'params'}: keys {got} != {sorted(want)}")
            return {k: convert(sub[k], want[k], f"{path}/{k}") for k in want}
        t = _tensor(sub, dev)
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{path}: shape {tuple(t.shape)} != {tuple(want)}")
        return t

    return convert(tree, shapes, "")
