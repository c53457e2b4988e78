"""Model registry.

Port of the JAX package's ``models/wrapper.py``: ``MODEL_REGISTRY`` /
``build_model`` (the denoisers: ``unet``, ``dsunet``, ``dsunet_split``,
``disc_unet``, ``dit`` and the DiT sizes by name, the MedSegDiff
denoisers ``medseg_v1`` (highway mode) and ``medseg_new`` (anchor mode),
and the first stage ``autoencoder_kl``) and ``conditioned_call``, the denoiser call
per conditioning mode, which returns whatever the model returns (a feature
model's ``(out, features)`` tuple included).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

from ..utils.device import resolve_device
from .disc_unet import DiscUNet
from .dit import DIT_CONFIGS, DiT, make_dit
from .dsunet import DSUNet
from .dsunet_cached import DSUNetSplit
from .seg_unet import MedSegDiffUNet
from .unet import UNet
from .vae import AutoencoderKL

__all__ = ["MODEL_REGISTRY", "build_model", "conditioned_call",
           "CONDITIONING_MODES"]

CONDITIONING_MODES = (
    "none", "concat", "crossattn", "hybrid", "adm", "hybrid-adm",
    "crossattn-adm",
)


def _as_list(v) -> list:
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v]


def conditioned_call(apply_fn: Callable, mode: str | None, x: torch.Tensor,
                     t: torch.Tensor, cond: dict | None = None, **kw):
    """Dispatch a denoiser call per conditioning mode (ddpm.py:1326-1361):
    ``c_concat`` joins x on the channel axis (NHWC, last), ``c_crossattn``
    becomes the context (joined on the token axis, 1), ``c_adm`` goes in as
    ``y``."""
    cond = cond or {}
    c_concat = _as_list(cond.get("c_concat"))
    c_crossattn = _as_list(cond.get("c_crossattn"))
    c_adm = cond.get("c_adm")

    if mode in ("none", None):
        return apply_fn(x, t, **kw)
    if mode == "concat":
        return apply_fn(torch.cat([x] + c_concat, dim=-1), t, **kw)
    if mode == "crossattn":
        return apply_fn(x, t, torch.cat(c_crossattn, dim=1), **kw)
    if mode == "hybrid":
        return apply_fn(torch.cat([x] + c_concat, dim=-1), t,
                        torch.cat(c_crossattn, dim=1), **kw)
    if mode == "adm":
        return apply_fn(x, t, y=c_adm, **kw)
    if mode == "hybrid-adm":
        return apply_fn(torch.cat([x] + c_concat, dim=-1), t, y=c_adm, **kw)
    if mode == "crossattn-adm":
        return apply_fn(x, t, torch.cat(c_crossattn, dim=1), y=c_adm, **kw)
    raise ValueError(f"unknown conditioning mode '{mode}'")


def _medseg(mode: str) -> Callable[..., nn.Module]:
    """The MedSegDiff factory of ``mode``. As in the JAX package it takes
    ``in_channels`` out of the keywords and passes everything else through;
    the torch module needs the width up front, so ``in_channels`` (x_t and
    the conditions) sets its ``cond_channels``."""

    def make(**kw):
        in_channels = kw.pop("in_channels", None)
        if in_channels is not None:
            kw.setdefault("cond_channels",
                          in_channels - kw.get("xt_channels", 1))
        return MedSegDiffUNet(mode=mode, **kw)

    return make


MODEL_REGISTRY: dict[str, Callable[..., Any]] = {
    "unet": UNet,
    "dsunet": DSUNet,
    "dsunet_split": DSUNetSplit,
    "disc_unet": DiscUNet,
    "dit": DiT,
    "autoencoder_kl": AutoencoderKL,
    "medseg_v1": _medseg("highway"),
    "medseg_new": _medseg("anchor"),
    **{name.lower(): (lambda n: (lambda **kw: make_dit(n, **kw)))(name)
       for name in DIT_CONFIGS},
}


def build_model(name: str, device: str | torch.device = "cuda",
                **params) -> nn.Module:
    """Build registered model ``name`` on ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    key = name.lower()
    if key not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown or not yet ported model '{name}' "
            f"(have {sorted(MODEL_REGISTRY)})"
        )
    return MODEL_REGISTRY[key](**params).to(dev)
