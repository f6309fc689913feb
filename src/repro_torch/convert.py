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


# the decoder groups the port runs, in stack order (models/model.py)
_GROUP_ORDER = ("dec_xlstm", "dec_gsuper", "dec_gtail", "dec_dec")


def params_from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Unstack the reference's scanned decoder groups into the port's
    per-layer list, and copy every leaf to ``device``.

    Each group (``dec_xlstm``; ``dec_gsuper`` then ``dec_gtail``; or
    ``dec_dec``) is a tuple of per-sub-block dicts whose leaves carry a
    leading ``count`` axis; layer j of the group is sub-block 0..n-1 of
    repetition j, and the groups follow each other in stack order.  A tree
    without ``unemb`` (tied embeddings) stays without it.  Caches are not
    converted: the port's cache has the reference's entries and shapes,
    with each attention entry's ``pos``/``btab`` (B, ·) shared by its
    layers as the reference's group-level ones are."""
    dev = resolve_device(device)
    groups = [k for k in tree if k.startswith(("dec_", "enc_"))]
    unknown = [g for g in groups if g not in _GROUP_ORDER]
    if unknown or not groups:
        raise NotImplementedError(
            f"params_from_jax converts the xLSTM and dense families only; "
            f"got groups {groups}")
    layers = []
    for name in sorted(groups, key=_GROUP_ORDER.index):
        subs = tree[name]
        count = int(np.shape(subs[0]["norm"]["scale"])[0])
        layers += [_map(sub, lambda a, j=j: tensor_from_numpy(a[j], dev))
                   for j in range(count) for sub in subs]
    out = {k: _map(v, lambda a: tensor_from_numpy(a, dev))
           for k, v in tree.items() if k not in groups}
    out["layers"] = layers
    return out
