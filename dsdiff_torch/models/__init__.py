"""Denoiser models (NHWC at the public ``forward``)."""
from .dsunet import DSUNet
from .dsunet_cached import DSUNetSplit, make_cached_denoiser
from .wrapper import MODEL_REGISTRY, build_model, conditioned_call

__all__ = ["DSUNet", "DSUNetSplit", "make_cached_denoiser", "MODEL_REGISTRY",
           "build_model", "conditioned_call"]
