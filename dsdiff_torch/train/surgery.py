"""Checkpoint weight surgery: adapt mismatched parameter shapes and
convert between the two encoder stream layouts.

Port of the JAX package's ``train/surgery.py``. It works on Flax-layout
param trees (nested dicts, lists and tuples of numpy arrays), before
``utils.flax_bridge`` maps them onto a model.

``fit_tensor`` / ``make_it_fit``: when loading pretrained weights whose
channel counts differ from the current model, each mismatched tensor is
filled by cycling the source values along the mismatched axes, so every
target element gets a (repeated) source element, averaged by use count.
``filtered_load``: loading with ignore-prefix lists.
``convert_stream_layout``: ``encoder_0..n-1`` subtrees <-> one ``encoders``
subtree with a leading stream axis.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

__all__ = ["fit_tensor", "make_it_fit", "filtered_load",
           "convert_stream_layout"]


def fit_tensor(old: np.ndarray, new_shape: tuple) -> np.ndarray:
    """Cycle source values into a differently-shaped target.

    Rank >= 2 with matching trailing dims: modulo-cycle the first two axes,
    then divide by a use count over the input axis (axis 1) that starts at
    one, so duplicated input channels don't inflate activations. Other
    shapes (rank change, trailing mismatch) fall back to generalized
    modulo-cycling.
    """
    old = np.asarray(old)
    new_shape = tuple(new_shape)
    if old.shape == new_shape:
        return old.copy()
    if old.ndim != len(new_shape):
        # rank change: flatten-cycle
        flat = old.reshape(-1)
        out = np.take(flat, np.arange(int(np.prod(new_shape))) % flat.size)
        return out.reshape(new_shape).astype(old.dtype)
    if old.ndim >= 2 and old.shape[2:] == new_shape[2:]:
        i = np.arange(new_shape[0]) % old.shape[0]
        j = np.arange(new_shape[1]) % old.shape[1]
        new = old[np.ix_(i, j)].astype(np.float64)
        # the use count starts at ones, +1 per target use
        n_used_old = np.ones(old.shape[1])
        for jj in j:
            n_used_old[jj] += 1
        n_used_new = n_used_old[j].reshape(
            (1, new_shape[1]) + (1,) * (old.ndim - 2)
        )
        return (new / n_used_new).astype(old.dtype)
    idx = np.indices(new_shape)
    src = tuple(idx[d] % old.shape[d] for d in range(old.ndim))
    return old[src].astype(old.dtype)


def make_it_fit(loaded_params, target_params):
    """Shape-adapt a loaded param tree onto the target's structure.

    Keys present in both trees are kept (shape-adapted when mismatched);
    target-only keys keep their fresh initialization; source-only keys are
    dropped. Trees are matched by flattened key-path strings.
    """
    l_flat = _flatten(loaded_params)

    def pick(key, tv):
        tv = np.asarray(tv)
        if key in l_flat:
            return fit_tensor(np.asarray(l_flat[key]), tv.shape).astype(tv.dtype)
        return tv

    return _map_with_path(pick, target_params)


def filtered_load(loaded_params, target_params,
                  ignore_prefixes: Sequence[str] = ()):
    """Drop ignored key prefixes; keep the target's init for anything
    missing or mismatched in shape."""
    l_flat = _flatten(loaded_params)

    def pick(key, tv):
        lv = l_flat.get(key)
        if (
            lv is None
            or any(key.startswith(p) for p in ignore_prefixes)
            or np.asarray(lv).shape != np.asarray(tv).shape
        ):
            return np.asarray(tv)
        return np.asarray(lv)

    return _map_with_path(pick, target_params)


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def _children(tree):
    """(key, child) pairs of a dict, list or tuple node."""
    return tree.items() if isinstance(tree, dict) else enumerate(tree)


def _map_with_path(fn: Callable, tree, prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn("a/b/leaf", leaf)``."""
    if not _is_node(tree):
        return fn(prefix, tree)
    out = [(k, _map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k)))
           for k, v in _children(tree)]
    if isinstance(tree, dict):
        return dict(out)
    return type(tree)(v for _, v in out)


def _flatten(tree) -> dict:
    flat = {}
    _map_with_path(flat.__setitem__, tree)
    return flat


def _leaves(tree) -> list:
    return list(_flatten(tree).values())


def _stacked_streams(node) -> int | None:
    """If every leaf under ``node`` shares the same leading dim in 2..8,
    return it (the stacked stream-axis layout), else None."""
    leaves = _leaves(node)
    if not leaves:
        return None
    dims = {
        (leaf.shape[0] if getattr(leaf, "ndim", 0) >= 1 else None)
        for leaf in leaves
    }
    if len(dims) == 1:
        (d,) = dims
        if d is not None and 2 <= d <= 8:
            return int(d)
    return None


def _stack(subs: list):
    """Trees of one structure -> one tree whose leaves are stacked on a new
    leading axis."""
    first = subs[0]
    if not _is_node(first):
        return np.stack([np.asarray(leaf) for leaf in subs], 0)
    out = [(k, _stack([s[k] for s in subs])) for k, _ in _children(first)]
    if isinstance(first, dict):
        return dict(out)
    return type(first)(v for _, v in out)


def convert_stream_layout(tree):
    """Convert DSUNet params between encoder layouts, both ways.

    ``stream_mode='vmap'`` stores the per-stream encoders as ONE subtree
    ``encoders`` whose leaves carry a leading stream axis; 'sequential'
    (the default) stores ``encoder_0..encoder_{n-1}`` subtrees with no
    stream axis. A tree written under one mode does not load under the
    other; this walks any nested dict/list tree and rewrites whichever
    layout it finds into the other (split the stream axis -> encoder_{i},
    or stack encoder_{i} -> encoders).
    """
    if isinstance(tree, (list, tuple)):
        return type(tree)(convert_stream_layout(v) for v in tree)
    if not isinstance(tree, dict):
        return tree
    out = {}
    enc_keys = sorted(
        (k for k in tree if isinstance(k, str)
         and k.startswith("encoder_") and k[len("encoder_"):].isdigit()),
        key=lambda k: int(k.split("_")[-1]),
    )
    for k, v in tree.items():
        if k == "encoders":
            n = _stacked_streams(v)
            if n is not None:
                sub = convert_stream_layout(v)
                for i in range(n):
                    out[f"encoder_{i}"] = _map_with_path(
                        lambda _, leaf, i=i: leaf[i], sub
                    )
                continue
        if k in enc_keys:
            continue  # handled below as a group
        out[k] = convert_stream_layout(v)
    if enc_keys:
        out["encoders"] = _stack(
            [convert_stream_layout(tree[k]) for k in enc_keys]
        )
    return out
