"""Model registry.

Port of the JAX package's ``models/wrapper.py`` ``MODEL_REGISTRY`` /
``build_model``. It holds the models ported so far; the others come with
ROADMAP A17, and ``conditioned_call`` with A13.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

from ..utils.device import resolve_device
from .dsunet import DSUNet
from .dsunet_cached import DSUNetSplit

__all__ = ["MODEL_REGISTRY", "build_model"]

MODEL_REGISTRY: dict[str, Callable[..., Any]] = {
    "dsunet": DSUNet,
    "dsunet_split": DSUNetSplit,
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
