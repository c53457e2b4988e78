"""Shared helpers for the parity tests of dsdiff_torch against dsdiff_tpu.

Inputs and weights are made with numpy from a seed and handed to both
packages; Flax param trees go into the port through its layout bridge.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke

# a narrow DSUNet: two levels, attention at rate 2 (8² on a 16² input)
TINY = dict(
    model_channels=32, num_res_blocks=1, attention_resolutions=[2],
    channel_mult=[1, 2], num_head_channels=16, use_scale_shift_norm=True,
)


@pytest.fixture(scope="module")
def one_thread():
    """torch on one CPU thread for a module's tests. With six xdist workers
    on eight cores each process's torch thread pool spins against the
    others': a file of tiny train steps that takes 6 s alone took 470 s
    under that load."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_cfg(steps=3):
    """The flagship run config with the TINY model, f32 and DDIM-``steps``."""
    cfg = dict(chip_smoke.FLAGSHIP_CONFIG)
    cfg.update(bf16=False, unet_config={"params": TINY},
               sampler_setting={"sampler": "ddim", "sample_steps": steps})
    return cfg


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
