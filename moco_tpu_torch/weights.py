"""Carry flax weights into the port's modules: the ResNets, the ViT and the
MoCo-v3 heads.

`params_to_jax(state_dict)` is the inverse: the flax trees (numpy leaves)
of a port state_dict, the layout of the `backbone/` checkpoint dialect.

`params_from_jax(params, batch_stats)` takes the flax `params` and
`batch_stats` trees as nested mappings of numpy arrays and returns a
`state_dict` for the port's module (the port keeps flax's module names, so
a path maps to a dotted name):

    conv       kernel [H, W, I, O]  -> weight [O, I, H, W]
    dense      kernel [in, out]     -> weight [out, in];  bias -> bias
    attention  kernel [D, H, hd] or [H, hd, D] -> weight, the same layout;
               bias [H, hd] -> bias, the same
    BN, LN     scale / bias         -> weight / bias
    BN         mean / var           -> running_mean / running_var
    ViT        cls_token [1, 1, D]  -> cls_token
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaf(name: str, value) -> tuple[str, np.ndarray]:
    arr = np.asarray(value, dtype=np.float32)
    if name == "kernel":
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 3:
            return "weight", arr
        if arr.ndim == 2:
            return "weight", arr.T
        raise ValueError(f"unexpected kernel rank {arr.ndim}")
    if name == "cls_token":
        return "cls_token", arr
    if name == "scale":
        return "weight", arr
    if name == "bias":
        return "bias", arr
    raise ValueError(f"unexpected parameter leaf {name!r}")


def _walk(tree: Mapping, prefix: str, leaf_fn, out: dict) -> None:
    for name, value in tree.items():
        if isinstance(value, Mapping):
            _walk(value, f"{prefix}{name}.", leaf_fn, out)
        else:
            key, arr = leaf_fn(name, value)
            out[prefix + key] = torch.tensor(np.ascontiguousarray(arr))  # a copy


def _stat(name: str, value) -> tuple[str, np.ndarray]:
    if name not in _STAT_NAMES:
        raise ValueError(f"unexpected batch_stats leaf {name!r}")
    return _STAT_NAMES[name], np.asarray(value, dtype=np.float32)


def params_from_jax(params: Mapping, batch_stats: Mapping | None = None) -> dict:
    """flax (params, batch_stats) trees -> the port's state_dict."""
    out: dict[str, torch.Tensor] = {}
    _walk(params, "", _leaf, out)
    if batch_stats:
        _walk(batch_stats, "", _stat, out)
    return out


def params_to_jax(state_dict: Mapping) -> tuple[dict, dict]:
    """The port's state_dict -> flax (params, batch_stats) trees of numpy
    arrays (copies)."""
    params: dict = {}
    stats: dict = {}
    inverse = {v: k for k, v in _STAT_NAMES.items()}
    for name, value in state_dict.items():
        *mods, leaf = name.split(".")
        arr = value.detach().cpu().numpy()
        if leaf in inverse:
            tree, key = stats, inverse[leaf]
        elif leaf in ("bias", "cls_token"):
            tree, key = params, leaf
        elif leaf == "weight" and arr.ndim == 3:
            tree, key = params, "kernel"
        elif leaf == "weight" and arr.ndim == 4:
            tree, key, arr = params, "kernel", arr.transpose(2, 3, 1, 0)
        elif leaf == "weight" and arr.ndim == 2:
            tree, key, arr = params, "kernel", arr.T
        elif leaf == "weight" and arr.ndim == 1:
            tree, key = params, "scale"
        else:
            raise ValueError(f"unexpected state_dict entry {name!r} {arr.shape}")
        for m in mods:
            tree = tree.setdefault(m, {})
        tree[key] = arr.copy(order="C")
    return params, stats
