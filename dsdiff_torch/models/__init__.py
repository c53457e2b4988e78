"""Denoiser models (NHWC at the public ``forward``)."""
from .dsunet import DSUNet
from .wrapper import MODEL_REGISTRY, build_model

__all__ = ["DSUNet", "MODEL_REGISTRY", "build_model"]
