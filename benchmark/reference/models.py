"""The reference denoisers, found by the configuration's ``model`` name.

Each kind is one file, ``benchmark/reference/denoisers/<model>.py``, in
plain f32 PyTorch built from ``benchmark/reference/layers.py``. It exposes

- ``build(config) -> nn.Module``: the reference model of a benchmark
  configuration file, at its published widths;
- ``tiny(config) -> config``: the configuration cut to a size the CPU runs
  in seconds (the benchmark's own tests).

The forward's contract, for every kind: ``model(x, t)`` takes NHWC ``x``
[B, H, W, 1 + n_cond] (the chain's channel, then the configuration's
``n_cond`` conditions) and a [B] float timestep ``t``, and returns
``(out [B, H, W, C_out], features or None)``, C_out being ``output_ch``,
doubled under ``learn_sigma`` (``out_channels``). ``features`` is read only
where the trainer block sets ``disentangle_distance`` (the disentangle
losses of ``diffusion.train_objective``). Parameter names are the port's,
so one seeded fill gives both sides the same weights.
"""
from __future__ import annotations

import contextlib
import copy
import importlib.util
from pathlib import Path

import torch
from torch import nn

DENOISERS = Path(__file__).resolve().parent / "denoisers"


def denoiser(kind: str):
    """The module of ``DENOISERS/<kind>.py``."""
    path = DENOISERS / f"{kind}.py"
    if not path.is_file():
        raise ValueError(f"no reference for model '{kind}': {path} not found")
    spec = importlib.util.spec_from_file_location(
        "benchmark_denoiser_" + kind.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build(config: dict, device=None) -> nn.Module:
    """The reference model of ``config`` (its ``model`` kind's ``build``),
    made on ``device`` (default: the current one)."""
    module = denoiser(config["model"])
    with contextlib.nullcontext() if device is None else torch.device(device):
        return module.build(config)


def in_channels(config: dict) -> int:
    return 1 + int(config["n_cond"])


def out_channels(config: dict) -> int:
    tr = config["trainer"]
    return int(tr.get("output_ch", 1)) * (2 if tr.get("learn_sigma", False)
                                          else 1)


def nhwc(x):
    return x.movedim(-3, -1)


def stage_kw(p: dict) -> dict:
    """The encoder / middle / decoder settings of ``unet_config.params``."""
    return dict(
        model_channels=int(p.get("model_channels", 96)),
        num_res_blocks=int(p.get("num_res_blocks", 2)),
        attention_resolutions=tuple(p.get("attention_resolutions", (4, 8))),
        channel_mult=tuple(p.get("channel_mult", (1, 2, 4, 8))),
        num_heads=int(p.get("num_heads", 8)),
        num_head_channels=int(p.get("num_head_channels", -1)),
        use_scale_shift_norm=bool(p.get("use_scale_shift_norm", False)),
    )


def unet_tiny(config: dict) -> dict:
    """A UNet kind's ``tiny``: 32 channels over two levels, attention at
    rate 2 in 16-wide heads (or 2 heads), 32² images, and the attention
    calls that leaves ([256, 2, 16, 4])."""
    cfg = copy.deepcopy(config)
    params = cfg["trainer"]["unet_config"]["params"]
    params.update(model_channels=32, channel_mult=[1, 2],
                  attention_resolutions=[2])
    if "num_head_channels" in params:
        params["num_head_channels"] = 16
    else:
        params["num_heads"] = 2
    cfg["trainer"]["image_size"] = 32
    cfg["attention_calls"] = [[256, 2, 16, 4]]
    return cfg
