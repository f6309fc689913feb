"""Reference parameters -> the port's parameters.

Takes the reference model's parameter tree with its leaves already turned
into numpy arrays (``jax.tree.map(np.asarray, params)``), so that this
module needs neither JAX nor the reference package.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """Exact copy; numpy's bfloat16 (ml_dtypes) goes through its bits."""
    a = np.array(a, order="C")          # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Unstack the scanned ``dec_xlstm`` group (a tuple of per-sub dicts,
    each leaf with a leading ``count`` axis) into the port's per-layer list
    in stack order, and copy every leaf to ``device``."""
    dev = resolve_device(device)
    groups = [k for k in tree if k.startswith(("dec_", "enc_"))]
    if groups != ["dec_xlstm"]:
        raise NotImplementedError(
            f"params_from_jax converts the xLSTM family only; got groups "
            f"{groups}")
    subs = tree["dec_xlstm"]
    count = int(np.shape(subs[0]["norm"]["scale"])[0])
    layers = [_map(sub, lambda a, j=j: tensor_from_numpy(a[j], dev))
              for j in range(count) for sub in subs]
    out = {k: _map(v, lambda a: tensor_from_numpy(a, dev))
           for k, v in tree.items() if k != "dec_xlstm"}
    out["layers"] = layers
    return out
