"""Denoiser models (NHWC at the public ``forward``)."""
from .disc_unet import DiscUNet
from .dit import DIT_CONFIGS, DiT, make_dit
from .dsunet import DSUNet
from .dsunet_cached import DSUNetSplit, make_cached_denoiser
from .unet import UNet
from .wrapper import MODEL_REGISTRY, build_model, conditioned_call

__all__ = ["UNet", "DSUNet", "DSUNetSplit", "DiscUNet", "DiT", "DIT_CONFIGS",
           "make_dit", "make_cached_denoiser", "MODEL_REGISTRY", "build_model",
           "conditioned_call"]
