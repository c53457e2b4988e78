"""Shared helpers for the parity tests of dsdiff_torch against dsdiff_tpu.

Inputs and weights are made with numpy from a seed and handed to both
packages; Flax param trees go into the port through its layout bridge.
"""
from __future__ import annotations

import numpy as np
import torch


def random_flax_params(tree, seed: int) -> dict:
    """A Flax param tree of the same structure filled with seeded, scaled
    normals (kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1²), biases
    N(0, 0.1²)), so zero-initialised output layers are not zero. Returns
    nested dicts of float32 numpy arrays."""
    rng = np.random.default_rng(seed)

    def fill(node, name=""):
        if hasattr(node, "items"):
            return {k: fill(v, k) for k, v in sorted(node.items())}
        shape = np.shape(node)
        noise = rng.standard_normal(shape).astype(np.float32)
        if name == "kernel":
            return noise / np.sqrt(np.prod(shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * noise
        return 0.1 * noise

    return fill(tree)


def nhwc_to_nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nchw_to_nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()
