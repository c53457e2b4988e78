"""Flax param tree -> PyTorch ``state_dict``.

The inverse of the JAX package's ``utils/torch_io.py:233-250 to_flax``. The port's
modules carry the Flax module names as attribute names, so a Flax path
``encoder_0/down_0_0_res/in_norm/norm/scale`` becomes the torch key
``encoder_0.down_0_0_res.in_norm.norm.weight`` (GroupNorm32's extra ``norm``
level included). Leaves translate as:

- conv ``kernel`` HWIO -> ``weight`` OIHW,
- a transposed conv's ``kernel`` HWIO -> ``weight`` [I, O, kh, kw],
  spatially flipped (Flax's ``ConvTranspose`` is ``lax.conv_transpose``
  with ``transpose_kernel=False``, which equals torch's
  ``conv_transpose2d`` with the flipped kernel); the target module's type,
  not the kernel's rank, decides this layout, so a transposed conv whose
  in and out widths are equal cannot take the plain conv's,
- FFParser's ``complex_weight`` [H, W//2+1, C, 2] -> [C, H, W//2+1, 2],
- Dense ``kernel`` [in, out] -> ``weight`` [out, in],
- norm ``scale`` (GroupNorm, LayerNorm) -> ``weight``; ``bias`` unchanged;
- ``Embed``'s ``embedding`` [num, features] -> ``nn.Embedding``'s
  ``weight``, the same layout (the UNet's ``label_emb``, ``ClassEmbedder``);
- a module's own parameter keeps its name (``EncoderUNet``'s
  ``pool_query``);
- under a stacked subtree (``stream_mode='vmap'``: ``encoders``,
  ``cond_encoders``) every leaf keeps its leading stream axis, and the
  target parameter's rank says which layout a kernel has.

The transformer path's modules (``SpatialTransformer``'s ``proj_in``,
``block_{i}`` with ``norm1..3``, ``attn1``/``attn2``'s ``to_q``, ``to_k``,
``to_v``, ``to_out`` and ``ff``'s ``proj_in``/``proj_out``; DSUNet's
``fusion_attn``) carry their Flax names, so the same rules hold for them,
in a stacked encoder too. The same rules carry the latent pipeline's
networks: the KL-VAE (``models.vae``: its bottleneck attention's separate
``q``, ``k``, ``v`` and ``proj_out`` Denses, ``quant_conv`` and
``post_quant_conv``), the
``PatchDiscriminator`` (whose GroupNorms are bare ``nn.GroupNorm``
modules: ``norm_1/scale`` -> ``norm_1.weight``) and the perceptual loss's
random-feature pyramid and VGG16 trunk (``eval.perceptual``).

``train_state_from_flax`` maps a whole JAX training state (params, EMA,
AdamW moments and counts) onto the model's keys, for ``TrainState.load``,
so that a run trained with the JAX package continues in the port.
"""
from __future__ import annotations

import math
import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["flatten_tree", "flax_to_state_dict", "train_state_from_flax",
           "random_params"]


def flatten_tree(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts of arrays -> ``{"a/b/leaf": np.ndarray}``. A top-level
    ``{"params": ...}`` wrapper (Flax variables) is dropped."""
    if not prefix and set(tree) == {"params"}:
        tree = tree["params"]
    flat: dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(flatten_tree(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "embedding": "weight", "pool_query": "pool_query",
               "complex_weight": "complex_weight"}


def _leaf_to_torch(arr: np.ndarray, leaf: str, target_ndim: int,
                   module: nn.Module | None = None) -> np.ndarray:
    """A Flax leaf in the layout of a torch parameter of rank
    ``target_ndim`` in ``module``. A transposed conv's kernel (by the
    module's type) goes to [I, O, kh, kw] flipped; other kernels move their
    axes by the target's rank: a Dense (2), a conv (4), or one of those
    with a leading stream axis (3, 5). ``complex_weight`` moves its channel
    axis first; scales and biases keep their layout."""
    if leaf == "complex_weight":  # [H, W', C, 2] -> [C, H, W', 2]
        return arr.transpose(2, 0, 1, 3)
    if leaf != "kernel":
        return arr
    if arr.ndim != target_ndim:
        raise ValueError(
            f"kernel of rank {arr.ndim} for a weight of rank {target_ndim}"
        )
    if isinstance(module, nn.ConvTranspose2d):
        if target_ndim != 4:
            raise ValueError("a stacked transposed conv has no torch layout")
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)
    if target_ndim == 2:  # Dense [in, out] -> [out, in]
        return arr.T
    if target_ndim == 4:  # conv HWIO -> OIHW
        return arr.transpose(3, 2, 0, 1)
    if target_ndim == 3:  # stacked Dense [S, in, out] -> [S, out, in]
        return arr.transpose(0, 2, 1)
    if target_ndim == 5:  # stacked conv [S, H, W, I, O] -> [S, O, I, H, W]
        return arr.transpose(0, 4, 3, 1, 2)
    raise ValueError(f"kernel of rank {arr.ndim} has no torch layout")


def flax_to_state_dict(tree: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """Translate a Flax param tree onto ``model``'s ``state_dict`` keys.

    Raises ``KeyError`` if any model key is missing from the tree or any tree
    leaf is unused, and ``ValueError`` on a shape mismatch.
    """
    expected = model.state_dict()
    out: dict[str, torch.Tensor] = {}
    unused = []
    for path, arr in flatten_tree(tree).items():
        *mods, leaf = path.split("/")
        if leaf not in _LEAF_NAMES:
            raise ValueError(f"unknown Flax leaf '{leaf}'")
        key = ".".join(mods + [_LEAF_NAMES[leaf]])
        if key not in expected:
            unused.append(path)
            continue
        want = tuple(expected[key].shape)
        val = _leaf_to_torch(arr, leaf, len(want),
                             model.get_submodule(".".join(mods)))
        if tuple(val.shape) != want:
            raise ValueError(
                f"{path}: shape {tuple(val.shape)} does not fit {key} {want}"
            )
        out[key] = torch.from_numpy(np.array(val, np.float32, order="C"))
    missing = sorted(set(expected) - set(out))
    if missing or unused:
        raise KeyError(
            f"Flax tree does not match the model: missing {missing[:8]} "
            f"({len(missing)}), unused {sorted(unused)[:8]} ({len(unused)})"
        )
    return out


def train_state_from_flax(tree: Mapping, model: nn.Module) -> dict:
    """Translate a JAX training state, as numpy, onto ``model``'s keys.

    ``tree`` holds ``params`` and ``ema_params`` (Flax param trees), ``mu``
    and ``nu`` (the AdamW moments, trees of the same structure), ``count``
    (optax's update count) and ``step``. Returns the keyword arguments of
    ``TrainState.load``: ``params``, ``ema``, ``mu`` and ``nu`` as state
    dicts, ``count`` and ``step`` as ints.
    """
    out = {name: flax_to_state_dict(tree[key], model)
           for name, key in (("params", "params"), ("ema", "ema_params"),
                             ("mu", "mu"), ("nu", "nu"))}
    out["count"] = int(tree["count"])
    out["step"] = int(tree["step"])
    return out


# a transformer block's LayerNorm scale (a GroupNorm32's is ``normN.norm``)
_LAYER_NORM = re.compile(r"(^|\.)norm\d\.weight$")


@torch.no_grad()
def random_params(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter with seeded, scaled normals, in place.

    Weights get ``N(0, 1/fan_in)``, norm scales (GroupNorm's, and the
    transformers' LayerNorms ``norm1``..``norm3``) ``1 + N(0, 0.1²)`` and
    biases ``N(0, 0.1²)``, so the zero-initialised layers (every ``OutHead``, the
    ResBlocks' second conv, DiT's ``adaLN``, ``final_adaLN`` and
    ``final_proj``) are not zero and a random model's output depends on
    every layer. Drawn on the CPU from a
    ``torch.Generator`` in name order, so the fill is the same on any device.
    Parameters under the model's ``stacked_prefixes`` carry a leading stream
    axis, and each stream's slice is filled by the same rules.
    """
    gen = torch.Generator().manual_seed(seed)
    stacked = tuple(getattr(model, "stacked_prefixes", ()))
    for name, p in sorted(model.named_parameters()):
        noise = torch.randn(p.shape, generator=gen, dtype=torch.float32)
        one = p[0] if name.startswith(stacked) else p
        if one.ndim >= 2:
            val = noise / math.sqrt(one[0].numel())
        elif name.endswith("norm.weight") or _LAYER_NORM.search(name):
            val = 1.0 + 0.1 * noise
        else:
            val = 0.1 * noise
        p.copy_(val)
    return model
