"""Denoiser models, the KL-VAE first stage and its discriminator, the
guidance classifier, the conditioning encoders, and the segmentation
networks with the MedSegDiff denoisers (NHWC at the public ``forward``)."""
from .disc_unet import DiscUNet
from .discriminator import PatchDiscriminator
from .dit import DIT_CONFIGS, DiT, make_dit
from .dsunet import DSUNet
from .dsunet_cached import DSUNetSplit, make_cached_denoiser
from .encoder_unet import EncoderUNet, classifier_gradient
from .encoders import ClassEmbedder, EmbeddingNoiseAugmentation, unclip_adm_cond
from .seg_unet import (FFParser, HighwayUNet, MedSegDiffUNet, SegUNet,
                       sliding_window_inference)
from .unet import UNet
from .vae import AutoencoderKL, DiagonalGaussian
from .wrapper import MODEL_REGISTRY, build_model, conditioned_call

__all__ = ["UNet", "DSUNet", "DSUNetSplit", "DiscUNet", "DiT", "DIT_CONFIGS",
           "make_dit", "make_cached_denoiser", "AutoencoderKL",
           "DiagonalGaussian", "PatchDiscriminator", "EncoderUNet",
           "classifier_gradient", "ClassEmbedder",
           "EmbeddingNoiseAugmentation", "unclip_adm_cond", "FFParser",
           "SegUNet", "HighwayUNet", "MedSegDiffUNet",
           "sliding_window_inference", "MODEL_REGISTRY", "build_model",
           "conditioned_call"]
