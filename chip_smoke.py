"""Smoke run of the PyTorch port (``dsdiff_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``dsdiff_torch/ops/csrc/``,
holds each against its plain PyTorch version at the main path's shapes and
times both (with one PyTorch library call beside them as a yardstick;
kernels and library calls also as CUDA graphs, which leave the host out),
then drives the main path in both directions:

- serving: full-width flagship DSUNet forwards with the attention kernel
  against the same forwards with plain attention, in f32 (the kernel's
  tf32x3 route) and in bf16 (its wgmma route), then three DDIM-20 requests
  at 256² through ``Trainer.sample_fn``;
- the fused GroupNorm + SiLU op (two kernels, statistics included) through
  ``dsdiff_torch.ops`` at the flagship ResBlock norm shapes;
- training: one full-width f32 loss + gradient with the attention kernel
  against plain attention, then at least five bf16 train steps at batch 8,
  256², through ``Trainer.train_step`` (f32 master weights, remat), and one
  DDIM-20 request from the EMA weights scored with ``val_metrics``;
- every other way the flagship serves: the cached-condition split model
  (``net_mode: ds_diff_split``) and the stacked stream layout in f32 against
  the plain and the sequential forwards, three DDIM-20 requests through the
  cached sampler, and on the flagship trainer one request through each
  other sampler (DPM-Solver++(2M), PLMS, ancestral, the DPM-Solver family
  multistep, singlestep and adaptive) set by ``Trainer.set_sampler``, then
  DDIM again, which must reproduce the first request;
- the flagship trained on data and predicting volumes through the entry
  points a user calls: a synthetic slice store (the npy case store: the
  card's machine has no ``h5py``), ``Trainer(cfg, workdir)`` with its K-fold
  split and loaders, ``fit`` at the config's batch 32 (three steps, a
  validation, a checkpoint), a second ``Trainer`` on the same workdir that
  restores the checkpoint bit for bit and resumes ``fit`` at epoch 1, then
  ``predict`` writing one NIfTI volume per test case and the metric report;
- the flagship's other run modes: ``int8`` (the int8 convolution's int32
  sums exact against an f64 conv at every eligible conv shape of the
  forward, the four heaviest timed against the bf16 cuDNN conv, DDIM-20
  requests with ``set_sampler(int8=True)`` and ``'static'``, calibrated on
  the synthetic store's val split, each running every eligible conv in
  int8, ``int8=False`` restoring the bf16 request bit for bit, and an int8
  request on the cached ``ds_diff_split`` sampler), ``cache`` (``fit`` at
  batch 32 with ``device_data_cache: true`` beside the host loader's, no
  batch copied from the host in the steady state by ``torch.profiler``'s
  trace, the cache's batch against its plain gather + augment) and
  ``dist`` (``fit`` through the mesh path on one NCCL rank against the
  mesh-less ``fit`` from the same seed);
- the other denoisers the run config names and palette (``families``):
  ``ddpm`` (UNet), ``disc_diff`` (DiscUNet, attention at head dim 192),
  ``palette`` (the gamma-conditioned UNet) and ``dit`` (DiT-B/8), each at
  its config's full width and 256²: full-width f32 and bf16 forwards with
  the attention kernel against plain attention, one request through
  ``Trainer.sample_fn`` and three bf16 train steps through
  ``Trainer.train_step``;
- the latent pipeline (``latent``): the attention kernel at the KL-VAE's
  single 512-wide head and the latent UNet's shapes, full-width f32 and
  bf16 parity of the VAE's encode and decode and of the latent UNet, the
  VAE's GAN training through ``VaeTrainer`` (configs/autoencoder_kl.yaml,
  batch 8 at 256², ``disc_start`` cut to 0) with a checkpoint and
  ``reconstruction_metrics``, the same through ``python -m
  dsdiff_torch.cli.train_vae``, then the latent ``Trainer``
  (configs/train_config.yaml + latent.yaml at batch 8) on that checkpoint:
  ``fit``, one DDIM-20 request decoded to 256² and
  ``progressive_denoise``, then ``predict`` and ``python -m
  dsdiff_torch.cli.sample`` on a split of one test case.

- the transformer conditioning path: the attention kernel at its shapes
  (the crossattn fusion's [4, 64, 8, 36] self- and cross-attention, M =
  256, whose 72-byte head stride the bf16 route loads through its threads;
  the patched tiles'; the guidance classifier's), then the flagship with
  ``fusion: crossattn``, with ``use_spatial_transformer: true`` and with
  ``use_fft_attention`` as well (``transformer``: full-width forward
  parity kernel vs plain, a DDIM-20 request, three bf16 train steps), a
  split-input request (``patched``: ``split_input_params`` 128² tiles at
  stride 64, one model call over 36 tiles a step, held to plain attention,
  its wall against the unpatched request's) and a classifier-guided
  request (``guided``: the ddpm UNet and an EncoderUNet's gradient through
  the kernel's autograd.Function, held to plain attention).
- MedSegDiff (``medseg``): the attention kernel at its [4|8, 1024, 4, 32]
  (and the f32 parity forward's [2, 1024, 4, 32]); ``medseg_v1`` (highway)
  and ``medseg_new`` (anchor) at the JAX package's defaults, 256²: forwards
  f32 and bf16 against plain attention, a DDIM-20 request through
  ``make_sample_fn`` and three bf16 train steps through ``make_train_step``
  (the JAX ``Trainer`` cannot build these models, nor can the port's),
  with every parameter the loss reaches moved and every other one
  untouched; SegUNet's sliding-window inference over a 320 x 320 x 20
  volume, labels against the same call on the CPU.
- adversarial disentanglement (``adversarial``): the flagship and the
  spectral-norm ContentDiscriminator on its content features, one f32
  ``model_step`` against plain attention (loss, loss_adv, every gradient),
  then three bf16 rounds of ``model_step`` + ``disc_step`` beside the
  flagship's own train step.

``python3 chip_smoke.py --phases int8,cache,dist`` runs only the named
phases (device and build always run; the kernels line needs every phase).
Each main-path run checks that every call of its kernels went through them.
Weights are random, from a seed. Exits non-zero, before printing any
result, when there is no CUDA device or when any phase fails. The last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

import torch
import torch.nn.functional as F

from dsdiff_torch import ops
from dsdiff_torch.core import sampling, schedules
from dsdiff_torch.data import synthetic
from dsdiff_torch.data.nifti import Nifti, read_nifti, write_nifti
from dsdiff_torch.models import attention as attention_module
from dsdiff_torch.models import build_model
from dsdiff_torch.models import dit as dit_module
from dsdiff_torch.models import vae as vae_module
from dsdiff_torch.models.attention import AttentionBlock
from dsdiff_torch.models.dsunet import FUSION_DEPTH
from dsdiff_torch.models.encoder_unet import EncoderUNet, classifier_gradient
from dsdiff_torch.models.seg_unet import SegUNet, sliding_window_probabilities
from dsdiff_torch.ops import _build
from dsdiff_torch.ops import flash_attention as fa
from dsdiff_torch.ops import fused_norm as fn
from dsdiff_torch.ops import quant
from dsdiff_torch.train.config import Config, load_run_config
from dsdiff_torch.train import adversarial
from dsdiff_torch.train import schedule_sampler as ss
from dsdiff_torch.train.state import TrainState, make_optimizer
from dsdiff_torch.train.step import (TaskConfig, make_sample_fn,
                                     make_train_step, train_loss)
from dsdiff_torch.train.surgery import convert_stream_layout
from dsdiff_torch.train.trainer import FEATURE_KINDS, Trainer, model_params
from dsdiff_torch.train.vae_loop import VaeTrainer
from dsdiff_torch.utils.device import disable_tf32
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict, random_params

# configs/train_config.yaml merged with configs/dsdiff_gaussian.yaml, on
# every key the port reads
FLAGSHIP_CONFIG = {
    "net_mode": "ds_diff_gaussian",
    "Task_name": "PET_synthesis",
    "Task_id": "r1",
    "fold_K": 5,
    "fold_idx": 1,
    "train_keys": ["F_Data1", "F_Data2", "S_Data1", "S_Data2"],
    "train_batch_size": 32,
    "val_batch_size": 8,
    "use_edge": False,
    "h5_2d_img_dir": "",
    "image_size": 256,
    "sampler_setting": {
        "sampler": "ddim", "ddim_use_original_steps": False, "sample_steps": 20,
    },
    "disentangle_distance": "eu",
    "contrast_lambda": 0.5,
    "output_ch": 1,
    "seed": 2024,
    "bf16": True,
    "parameterization": "v",
    "loss_type": "charbonnier",
    "noise_schedule": "linear",
    "linear_start": 1.0e-4,
    "linear_end": 2.0e-2,
    "diffusion_steps": 1000,
    "learn_sigma": True,
    "rescale_timesteps": False,
    "clip_denoised": True,
    "lr": 1.0e-4,
    "lr_low": 1.0e-7,
    "num_epochs": 250,
    "lr_warm_epoch": 0,
    "val_step": 5,
    "augmentation_prob": 0.4,
    "beta1": 0.9,
    "beta2": 0.999,
    "weight_decay": 0.0,
    "ema_rate": 0.9999,
    "schedule_sampler": "uniform",
    "remat": True,
    "unet_config": {
        "params": {
            "model_channels": 96,
            "num_res_blocks": 2,
            "attention_resolutions": [8, 16, 32],
            "channel_mult": [1, 1, 2, 2, 3, 3],
            "num_head_channels": 48,
            "use_scale_shift_norm": True,
        }
    },
}

# configs/train_config.yaml merged with configs/dsdiff_split.yaml, on every
# key the port reads: the split model's file leaves these of the flagship's
# to the trainer's defaults
_GAUSSIAN_ONLY = ("noise_schedule", "linear_start", "linear_end",
                  "rescale_timesteps", "clip_denoised", "weight_decay",
                  "ema_rate", "schedule_sampler")
SPLIT_CONFIG = {k: v for k, v in FLAGSHIP_CONFIG.items()
                if k not in _GAUSSIAN_ONLY}
SPLIT_CONFIG.update(net_mode="ds_diff_split", cached_cond_sampling=True)

SEED = 0
IMAGE = 256
SERVE_BATCH = 4
SERVE_REQUESTS = 3
DDIM_STEPS = 20
# attention calls of one flagship forward at 256²: (N, heads, D, calls)
ATTENTION_CALLS = [(1024, 4, 48, 11), (256, 6, 48, 11), (64, 6, 48, 12)]
CALLS_PER_FORWARD = sum(c for *_, c in ATTENTION_CALLS)  # 34
# the same 34 by part of the backbone (models/backbone.py): attention follows
# every res block at rates 8, 16 and 32, the last three of channel_mult's six
# levels. An encoder has 2 res blocks a level (3 x 2 = 6), the middle block
# one attention, the decoder 3 res blocks a level (3 x 3 = 9). DSUNet runs
# four encoders: 4 x 6 + 1 + 9 = 34.
ENCODER_ATTN, MIDDLE_ATTN, DECODER_ATTN = 6, 1, 9
# the split model: encode_conditions runs the three condition encoders once
# a request; a cached step is the noise encoder, the middle and the decoder
ENCODE_CALLS = 3 * ENCODER_ATTN                             # 18
CACHED_STEP_CALLS = ENCODER_ATTN + MIDDLE_ATTN + DECODER_ATTN  # 16
CACHED_REQUEST_CALLS = ENCODE_CALLS + CACHED_STEP_CALLS * DDIM_STEPS  # 338
# model calls of one 20-step request by sampler: PLMS calls the model twice
# at its first step; singlestep order 3 splits 20 into 6 groups of 3 and one
# of 2; multistep never calls the model after its last update
SAMPLER_MODEL_CALLS = [("dpm++", 20), ("plms", 21), ("ancestral", 20),
                       ("dpm", 20), ("dpm_singlestep", 20)]
# the adaptive solver's request: the full-width model at a small size
ADAPTIVE_BATCH, ADAPTIVE_IMAGE = 1, 64
# its attention shapes: the flagship's rows shrink with the image's area, to
# N = 64, 16 and 4, all under the kernel's 64-row tile
ADAPTIVE_ATTENTION = [(N * ADAPTIVE_IMAGE**2 // IMAGE**2, H, D)
                      for N, H, D, _ in ATTENTION_CALLS]

# the attention shapes of the other DS-Diff configs, error only, batch 4:
# (config, model_channels, head channels, image): attention at rates 8, 16
# and 32 with channel_mult 2, 3 and 3 there, so N = (image / rate)² and
# heads = mult * C / head channels
OTHER_CONFIGS = [("dsdiff_flagship128", 128, 32, 256),
                 ("dsdiff_thesis160", 160, 32, 256),
                 ("dsdiff_ldm320", 320, 32, 320),
                 ("train_config_BraTs", 96, 48, 192)]
OTHER_CONFIG_ATTENTION = [
    (name, ((image // rate) ** 2, mult * C // hc, hc))
    for name, C, hc, image in OTHER_CONFIGS
    for rate, mult in ((8, 2), (16, 3), (32, 3))]

# the other denoisers the run config names (configs/train_config.yaml:2)
# and palette, each run as configs/train_config.yaml merged with its model
# config (ddpm.yaml sets no net_mode: the run sets it): (net_mode, model
# config, attention calls of one forward at 256² as (N, heads, D, calls)).
# ddpm is the flagship's backbone with one encoder: attention after each res
# block at rates 8, 16, 32, 2 a level in the encoder and 3 in the decoder,
# and the middle's. disc_diff and palette: channel_mult (1, 2, 4, 8), so of
# rates 8 and 16 only 8 exists: 32² at 8 x 96 = 768 channels in 4 heads;
# disc_diff runs 4 encoders (4 x 2 + 1 + 3 = 12), palette one (2 + 1 + 3).
# dit: 12 blocks over the 32² tokens of 8² patches, 768 wide in 12 heads.
CONFIGS = Path(__file__).resolve().parent / "configs"
FAMILIES = [
    ("ddpm", "ddpm.yaml", [(1024, 4, 48, 5), (256, 6, 48, 5), (64, 6, 48, 6)]),
    ("disc_diff", "disc_diff.yaml", [(1024, 4, 192, 12)]),
    ("palette", "palette.yaml", [(1024, 4, 192, 6)]),
    ("dit", "dsdiff_gaussian.yaml", [(1024, 12, 64, 12)]),
]
FAMILY_TRAIN_STEPS = 3
# the families' own attention shapes, timed at these batches; head dims of
# the other DiT sizes (XL: 72) and round ones held error only, batch 4
FAMILY_KERNEL_BATCHES = (SERVE_BATCH, 8)
HEAD_DIM_HELD = [("DiT-XL/8 at 256²", (1024, 16, 72)),
                 ("D = 96", (1024, 8, 96)), ("D = 256", (1024, 3, 256))]

# the latent pipeline: the KL-VAE of configs/autoencoder_kl.yaml, whose
# bottleneck attention (encoder and decoder, one call each) is one head over
# 512 channels at 32² tokens for 256² images, and the latent UNet of
# configs/train_config.yaml + latent.yaml over 32² latents (C = 192,
# channel_mult (1, 2, 4), attention at rates 1, 2 and 4 in 64-channel
# heads: 2 a level in the encoder, the middle's, 3 a level in the decoder)
VAE_ATTENTION = (1024, 1, 512)
LATENT_ATTENTION_CALLS = [(1024, 3, 64, 5), (256, 6, 64, 5), (64, 12, 64, 6)]
LATENT_CALLS_PER_FORWARD = sum(c for *_, c in LATENT_ATTENTION_CALLS)  # 16
LATENT_N_COND = 3  # configs/train_config.yaml's four train_keys
# a latent request: the UNet at each step, each condition encoded, one
# decode; a latent train step: the conditions and the target encoded
LATENT_REQUEST_CALLS = (DDIM_STEPS * LATENT_CALLS_PER_FORWARD
                        + LATENT_N_COND + 1)                       # 324
LATENT_STEP_CALLS = LATENT_N_COND + 1 + LATENT_CALLS_PER_FORWARD  # 20
# a VAE GAN step: encode + decode in the AE step and in the disc step
VAE_STEP_CALLS = 4
VAE_TRAIN_STEPS = LATENT_TRAIN_STEPS = 3
VAE_BATCH = 8  # configs/autoencoder_kl.yaml's train_batch_size
# what the latent phase cuts of the configs' runs, each printed
VAE_CUTS = {"disc_start": (50001, 0)}
LATENT_CUTS = {"train_batch_size": (32, 8), "limit_val_batches": (8, 1),
               "log_images": (True, False)}
LATENT_KERNEL_BATCHES = (SERVE_BATCH, VAE_BATCH)

TRAIN_BATCH = 8  # bench.py's train batch
# the fit phase: the flagship config's own train batch, on a synthetic store
# of 12 cases x 16 slices at 256²: 3 test cases, and with fold_K 5 and
# fold_idx 1, 7 train cases (112 slices, 3 batches of 32) and 2 validation
# cases (32 slices, 4 batches of val_batch_size 8)
FIT_BATCH = FLAGSHIP_CONFIG["train_batch_size"]
VAL_BATCH = FLAGSHIP_CONFIG["val_batch_size"]
FIT_CASES, FIT_SLICES, FIT_TEST_CASES = 12, 16, 3
FIT_STEPS_PER_EPOCH = 3
# the synthetic store's sequence names: three conditions, the target last
FIT_KEYS = ["A", "B", "C", "GT"]
# what the fit phase cuts of the config's run, each printed
FIT_CUTS = {"limit_val_batches": (8, 1), "num_epochs": (250, 1),
            "log_images": (True, False)}
TRAIN_STEPS = 6
PARITY_BATCH = 2
# the flagship ResBlocks' input-norm shapes at 256² (H = W, C), 32 groups
NORM_SHAPES = [(256, 96), (128, 96), (64, 192), (32, 192), (16, 288), (8, 288)]
# scripts/kernel_bench.py's batch-16 shapes for the same kernel
NORM_SHAPES_B16 = [(256, 96), (128, 96), (64, 192), (32, 192), (16, 288)]
NORM_GROUPS = 32
L2_BYTES = 50 * 2**20

# H100 SXM published dense peaks at 700 W: bf16 tensor cores, f32 CUDA
# cores, TF32 tensor cores
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# kernel vs plain: f32 differs by summation order, the ~2^-22 left by the
# 3xTF32 split and ex2.approx (a few ulps); bf16 outputs are rounded from
# f32 in both, so they may differ by one bf16 ulp (2^-8 at magnitude 1)
KERNEL_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# full-width f32 forward, TF32 off, kernel vs plain attention: relative to
# the output's largest magnitude
MODEL_RTOL = 1e-3
# full-width bf16 forward, kernel (wgmma route) vs plain attention, relative
# to the output's largest magnitude. The two round each attention output to
# bf16 from f32 values that differ by summation order and by P entering the
# second product in bf16 (relative 2^-9), so an output may land one bf16 ulp
# (2^-8 relative) apart; the ~60 bf16 layers after the first attention block
# re-round such differences and GroupNorm rescales them, so they spread but
# stay at a few ulps of the output's scale. 5 ulps (2e-2) bounds that drift;
# a kernel fault (a mis-mapped fragment, a lost tile) moves the output by
# the order of max |out| itself.
MODEL_BF16_RTOL = 2e-2
# GroupNorm+SiLU, kernels vs plain, relative to max(1, max |plain|): f32
# differs by the statistics' summation order (f64 in the kernels) and expf
# vs PyTorch's sigmoid (a few ulps); bf16 is rounded from f32 in both, so
# one bf16 ulp (2^-7 relative at most) may separate them
NORM_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# full-width f32 loss and gradients, TF32 off, kernel vs plain attention.
# The forward differs by the kernel's summation order (~1e-6 of the output);
# the backward is the same plain math in both. Loss: relative. Gradients:
# relative to each leaf's largest magnitude (floored at 1e-3 of the model's
# largest, for leaves near zero whose gradient is rounding noise).
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
GRAD_NOISE_FLOOR = 1e-3
# the EMA after the first update is 0.1 p0 + 0.9 p1 (decay min(0.9999, 1/10))
# up to f32 rounding of the two products and the sum
EMA_RTOL = 1e-6


# the transformer conditioning path: the flagship with these
# unet_config.params overrides, each with its attention calls of one
# forward at 256². crossattn: the flagship's 34, and the fusion's depth-4
# SpatialTransformer over the 8² bottleneck (conv_ch 288 in max(num_heads,
# 1) = 8 heads of 36): a self- and a cross-attention a block. Spatial
# transformer: every AttentionBlock becomes a depth-1 transformer whose two
# attentions (its second without a context) both run the kernel; with FFT
# attention none does.
TRANSFORMER_RUNS = [
    ("crossattn", {"fusion": "crossattn"},
     CALLS_PER_FORWARD + 2 * FUSION_DEPTH),                        # 42
    ("spatial_transformer", {"use_spatial_transformer": True},
     2 * CALLS_PER_FORWARD),                                       # 68
    ("fft", {"use_spatial_transformer": True, "use_fft_attention": True}, 0),
]
# the fusion's two shapes: (N, heads, D, M keys, calls of one forward); the
# context is the four 8² feature maps, 256 tokens
FUSION_ATTENTION = [(64, 8, 36, 64, FUSION_DEPTH),
                    (64, 8, 36, 256, FUSION_DEPTH)]
# split-input sampling on the plain flagship: 128² tiles at stride 64 over
# 256², 3 x 3 = 9 a slice, one model call over all of a request's tiles;
# the flagship's attention at 128²: (N, heads, D, calls of one forward)
PATCH = {"ks": [128, 128], "stride": [64, 64]}
PATCH_TILES = 9
PATCH_ATTENTION = [(256, 4, 48, 11), (64, 6, 48, 11), (16, 6, 48, 12)]
# classifier guidance: configs/ddpm.yaml's UNet guided by an EncoderUNet at
# the JAX package's defaults at 256² (C = 64, channel_mult (1, 2, 4, 8),
# attention at rate 8: 32² tokens, 512 channels in 4 heads of 128, after
# the last level's two res blocks and in the middle), random weights
GUIDE_CLASSES = 2
CLASSIFIER_ATTENTION = [(1024, 4, 128, 3)]
CLASSIFIER_CALLS = sum(c for *_, c in CLASSIFIER_ATTENTION)        # 3
GUIDE_SCALE = 10.0
DDPM_CALLS = sum(c for *_, c in FAMILIES[0][2])                    # 16


# MedSegDiff (medseg_v1: highway mode; medseg_new: anchor mode) at the JAX
# package's defaults (C = 32, channel_mult (1, 2, 4, 4), one res block,
# attention at rate 8, 4 heads, highway 32) at 256² with the flagship's
# three conditions: attention at 32², 128 channels in 4 heads of 32, in the
# encoder's last level, the middle and the decoder's two blocks. The loss
# reaches no parameter under these prefixes: anchor mode adds the highway's
# anchors detached, and highway mode's seg map (the highway's decoder and
# seg_out) is in no loss.
MEDSEG_MODES = ("medseg_v1", "medseg_new")
MEDSEG_ATTENTION = [(1024, 4, 32, 4)]
MEDSEG_CALLS = sum(c for *_, c in MEDSEG_ATTENTION)               # 4
MEDSEG_UNREACHED = {"medseg_v1": ("hwm.up_", "hwm.seg_out."),
                    "medseg_new": ("hwm.",)}
MEDSEG_TRAIN_STEPS = 3
MEDSEG_LR = 1e-4
# SegUNet at its defaults over a synthetic [H, W, Z, C] volume: 256² tiles
# at overlap 0.5 (2 x 2 tiles), z-chunks of 8 (8, 8, 4 + 4 padding)
SEG_VOLUME = (320, 320, 20, 1)
SEG_TILE, SEG_OVERLAP, SEG_BATCH = 256, 0.5, 8
SEG_PROB_ATOL = 1e-5
# adversarial disentanglement on the flagship: its content features (three
# streams of the bottleneck's 288 / 2 channels at 8²) into the JAX
# package's default discriminator
ADV_DISC = dict(n_streams=3, base_channels=64, use_spectral_norm=True)
ADV_CONFIG = dict(adv_lambda=0.1, disc_start=0)
ADV_CONTENT = (3, 8, 8, 144)  # [streams, h, w, c] a batch row
ADV_ROUNDS = 3


# the int8, cache and dist phases (PR 9): the int8 convs timed, the H100
# SXM's dense int8 tensor-core peak at 700 W, the fit steps after the first,
# and the cache's batch against its plain version: the same grid_sample per
# sample, so f32 rounding at most
INT8_HEAVIEST = 4
INT8_PEAK_OPS = 1979e12
CACHE_STEPS = 3
DIST_STEPS = 5
CACHE_TOL = 1e-5
_STORE: dict = {}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def time_ms_cycling(fn, inputs, iters: int) -> float:
    """Mean device time of ``fn(*inputs[i % len(inputs)])``, CUDA events;
    the inputs rotate so that, together larger than the L2 cache, each
    call reads its operands from device memory as the model's would."""
    for args in inputs[:3]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms_graph(fn, inputs, replays: int = 5) -> float:
    """Mean device time of ``fn(*inputs[i % len(inputs)])``, one call per
    copy of the rotated inputs (at least 100 calls), captured in one CUDA
    graph and replayed: the host's cost per call is left out."""
    calls = max(100, len(inputs))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        for args in inputs[:3]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def rotated(tensors, nbytes: int) -> list:
    """``tensors`` and enough clones of them that one pass over all copies
    moves at least twice the L2 cache's ``nbytes`` (at most 1024 copies)."""
    copies = min(1024, max(1, -(-2 * L2_BYTES // nbytes)))
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors)
                               for _ in range(copies - 1)]


def attention_bound(B, N, H, D, dtype, M=None):
    """(ms, 'bytes' | 'operations'): q, k, v, o moved once at the memory
    rate, or 4*B*H*N*M*D operations (M keys, N by default) at the tensor
    cores' rate: bf16's, or for f32 three TF32 passes (the least an
    f32-accurate product costs on this card's tensor cores)."""
    M = N if M is None else M
    elem = torch.finfo(dtype).bits // 8
    t_bytes = 2 * B * (N + M) * H * D * elem / PEAK_BYTES_PER_S
    flops = 4 * B * H * N * M * D
    t_ops = (flops / PEAK_FLOPS[dtype] if dtype == torch.bfloat16
             else 3 * flops / TF32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name}, {count} device(s), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(f"[device] {smi}")
    return name, count, smi


def phase_build():
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {len(libs)} kernel librar(ies) in "
          f"{time.perf_counter() - t0:.2f} s")
    for lib in libs.values():
        log = lib.with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "spill" in line or "Loss" in line:
                print(f"[build] {line.strip()}")


def _attention_inputs(gen, batch, N, H, D, dtype, M=None,
                      layout="thirds"):
    """(buffers, views): q, k, v on the card as a model hands them to the
    kernel, ``views(*buffers)``: ``thirds``, strided thirds of one fused
    qkv buffer (``AttentionBlock``: M = N); ``dense``, each its own
    Dense(H*D) output viewed as heads, k and v over M tokens
    (``CrossAttention``)."""
    if layout == "thirds":
        qkv = torch.randn(batch, N, 3, H, D, generator=gen, device="cuda",
                          dtype=dtype)
        return (qkv,), lambda x: x.unbind(2)
    M = N if M is None else M
    bufs = tuple(torch.randn(batch, rows, H * D, generator=gen,
                             device="cuda", dtype=dtype)
                 for rows in (N, M, M))
    return bufs, lambda *b: tuple(t.view(batch, t.shape[1], H, D) for t in b)


def _load(q, k, v) -> str:
    """How the kernel loads these inputs: the bf16 route's TMA or its
    threads' copies; the f32 route's cp.async."""
    return fa.bf16_load(q, k, v) if q.dtype == torch.bfloat16 else "cp.async"


def _attention_row(gen, batch, N, H, D, dtype, calls, card: str, M=None,
                   layout="thirds") -> dict:
    """Kernel vs plain at one shape (M keys, N by default; q, k, v in the
    model's ``layout``, ``_attention_inputs``), the kernel, the plain
    version and SDPA timed (events and CUDA graph); fails on an error over
    KERNEL_TOL. The row names the kernel's load for the layout."""
    M = N if M is None else M
    bufs, views = _attention_inputs(gen, batch, N, H, D, dtype, M, layout)
    qkv = views(*bufs)
    load = _load(*qkv)
    got = fa.flash_attention(*qkv)
    torch.cuda.synchronize()
    want = fa.reference_attention(*qkv)
    err = (got.float() - want.float()).abs().max().item()
    del got, want, qkv
    tol = KERNEL_TOL[dtype]
    # copies of the buffers, each call's views cut from its own
    qkvs = rotated(bufs, sum(t.numel() * t.element_size() for t in bufs))
    sdpa_in = [tuple(t.transpose(1, 2).contiguous() for t in views(*x))
               for x in qkvs]
    iters = 50 if max(N, M) >= 1024 else 200
    kernel = lambda *x: fa.flash_attention(*views(*x))  # noqa: E731
    plain = lambda *x: fa.reference_attention(*views(*x))  # noqa: E731
    ms = time_ms_cycling(kernel, qkvs, iters)
    graph_ms = time_ms_graph(kernel, qkvs)
    plain_ms = time_ms_cycling(plain, qkvs, iters)
    lib_ms = time_ms_cycling(F.scaled_dot_product_attention, sdpa_in, iters)
    lib_graph_ms = time_ms_graph(F.scaled_dot_product_attention, sdpa_in)
    del qkvs, sdpa_in
    bound_ms, bound_by = attention_bound(batch, N, H, D, dtype, M)
    row = dict(shape=[batch, N, H, D], keys=M, layout=layout, load=load,
               dtype=str(dtype).split(".")[1],
               route=fa.ROUTES[dtype], calls_per_forward=calls,
               max_abs_err=err, tol=tol, ms=ms, graph_ms=graph_ms,
               plain_ms=plain_ms, library_ms=lib_ms,
               library_graph_ms=lib_graph_ms, bound_ms=bound_ms,
               bound_by=bound_by, share_of_bound=bound_ms / graph_ms)
    keys = f" x M={M}" if M != N else ""
    print(f"[kernel] flash_attention {row['shape']}{keys} {row['dtype']} "
          f"({row['route']}, {layout}, {load}): max_abs_err {err:.3e} "
          f"(tol {tol:.0e}), "
          f"kernel {ms:.5f} ms (graph {graph_ms:.5f}), plain "
          f"{plain_ms:.5f} ms, sdpa {lib_ms:.5f} ms (graph "
          f"{lib_graph_ms:.5f}), bound {bound_ms:.5f} ms "
          f"({bound_by}), {100 * bound_ms / graph_ms:.2f}% of bound "
          f"in the graph [{card}]")
    check(err <= tol, f"flash_attention {row['shape']} "
          f"{row['dtype']}: error {err} over {tol}")
    return row


def phase_kernels(card: str):
    """Kernel vs plain at the flagship attention shapes, with the calls of
    one flagship forward, and at the other families' (head dims 192 and 64),
    with ``families``: {family: calls of one forward}; returns the rows.
    bf16 runs the kernel's wgmma route, f32 its tf32x3 route."""
    disable_tf32()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for batch in (SERVE_BATCH, TRAIN_BATCH, 16, FIT_BATCH):
        for dtype in (torch.bfloat16, torch.float32):
            for N, H, D, calls in ATTENTION_CALLS:
                rows.append(_attention_row(gen, batch, N, H, D, dtype, calls,
                                           card))
    # the families' shapes past the flagship's (ddpm's are the flagship's),
    # each timed once: {(N, H, D): {family: calls per forward}}
    flagship_shapes = {(N, H, D) for N, H, D, _ in ATTENTION_CALLS}
    family_shapes: dict = {}
    for family, _, shapes in FAMILIES:
        for N, H, D, calls in shapes:
            if (N, H, D) not in flagship_shapes:
                family_shapes.setdefault((N, H, D), {})[family] = calls
    for batch in FAMILY_KERNEL_BATCHES:
        for dtype in (torch.bfloat16, torch.float32):
            for (N, H, D), families in family_shapes.items():
                row = _attention_row(gen, batch, N, H, D, dtype, None, card)
                rows.append(dict(row, families=families))
    # error only: the adaptive request's shapes (partial tiles in every
    # one), the other configs' (N mostly not a multiple of the 64-row
    # tile, 32-channel heads) and the other head dims the kernel takes
    held = ([("the adaptive request", ADAPTIVE_BATCH, shape)
             for shape in ADAPTIVE_ATTENTION]
            + [(name, SERVE_BATCH, shape)
               for name, shape in OTHER_CONFIG_ATTENTION]
            + [(name, SERVE_BATCH, shape) for name, shape in HEAD_DIM_HELD])
    for dtype in (torch.bfloat16, torch.float32):
        for what, batch, (N, H, D) in held:
            qkv = torch.randn(batch, N, 3, H, D, generator=gen,
                              device="cuda", dtype=dtype)
            q, k, v = qkv.unbind(2)
            got = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            want = fa.reference_attention(q, k, v)
            err = (got.float() - want.float()).abs().max().item()
            tol = KERNEL_TOL[dtype]
            shape, name = [batch, N, H, D], str(dtype).split(".")[1]
            print(f"[kernel] flash_attention {shape} {name} "
                  f"({fa.ROUTES[dtype]}, {what}): max_abs_err {err:.3e} "
                  f"(tol {tol:.0e})")
            check(torch.isfinite(got).all().item(),
                  f"flash_attention {shape} {name}: non-finite output")
            check(err <= tol,
                  f"flash_attention {shape} {name}: error {err} over {tol}")
    return rows


def norm_bound(B, H, W, C, dtype):
    """(ms, 'bytes' | 'operations') of the whole op: x read and y written
    once, scale and bias ([C] f32) read once, at the memory rate; or about
    9 FLOPs (3 for the statistics, 6 for the apply) and one exp per element
    on the f32 CUDA cores."""
    elem = torch.finfo(dtype).bits // 8
    n = B * H * W * C
    t_bytes = (2 * n * elem + 2 * C * 4) / PEAK_BYTES_PER_S
    t_ops = 10 * n / PEAK_FLOPS[torch.float32]
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _norm_inputs(gen, B, H, C, dtype):
    x = (torch.randn(B, H, H, C, generator=gen, device="cuda") * 2.0
         + 0.5).to(dtype)
    scale = torch.randn(C, generator=gen, device="cuda") * 0.1 + 1.0
    bias = torch.randn(C, generator=gen, device="cuda") * 0.1
    return x, scale, bias


def phase_norm_kernels(card: str):
    """GroupNorm+SiLU, the whole op through its two kernels, vs plain at the
    flagship ResBlock norm shapes (batch 4) and scripts/kernel_bench.py's
    (batch 16); two calls must agree bitwise. Returns the rows."""
    disable_tf32()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    cases = ([(SERVE_BATCH, H, C) for H, C in NORM_SHAPES]
             + [(16, H, C) for H, C in NORM_SHAPES_B16])
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for B, H, C in cases:
                x, scale, bias = _norm_inputs(gen, B, H, C, dtype)
                op = lambda x: fn.group_norm_silu(x, scale, bias, NORM_GROUPS)  # noqa: E731
                got = op(x)
                again = op(x)
                torch.cuda.synchronize()
                want = fn.group_norm_silu_plain(x, scale, bias, NORM_GROUPS)
                err = (got.float() - want.float()).abs().max().item()
                tol = NORM_TOL[dtype] * max(1.0, want.float().abs().max().item())
                check(got.dtype == dtype and got.shape == x.shape,
                      f"group_norm_silu output {got.dtype} {tuple(got.shape)}")
                check(err <= tol, f"group_norm_silu {[B, H, H, C]} {dtype}: "
                      f"error {err} over {tol}")
                check(torch.equal(got, again), f"group_norm_silu {[B, H, H, C]} "
                      f"{dtype}: two calls differ")
                xs = rotated([x], x.numel() * x.element_size())
                iters = 50 if x.numel() >= 2**24 else 200
                ms = time_ms_cycling(op, xs, iters)
                graph_ms = time_ms_graph(op, xs)
                plain_ms = time_ms_cycling(
                    lambda x: fn.group_norm_silu_plain(x, scale, bias,
                                                       NORM_GROUPS), xs, iters)
                w, bb = scale.to(dtype), bias.to(dtype)
                library = lambda x: F.silu(F.group_norm(  # noqa: E731
                    x.permute(0, 3, 1, 2), NORM_GROUPS, w, bb, 1e-5))
                lib_ms = time_ms_cycling(library, xs, iters)
                lib_graph_ms = time_ms_graph(library, xs)
                bound_ms, bound_by = norm_bound(B, H, H, C, dtype)
                row = dict(shape=[B, H, H, C], dtype=str(dtype).split(".")[1],
                           max_abs_err=err, tol=tol, ms=ms, graph_ms=graph_ms,
                           plain_ms=plain_ms, library_ms=lib_ms,
                           library_graph_ms=lib_graph_ms, bound_ms=bound_ms,
                           bound_by=bound_by, share_of_bound=bound_ms / graph_ms)
                rows.append(row)
                print(f"[kernel] group_norm_silu {row['shape']} {row['dtype']}: "
                      f"max_abs_err {err:.3e} (tol {tol:.1e}), bitwise equal "
                      f"twice, op {ms:.5f} ms (graph {graph_ms:.5f}), plain "
                      f"{plain_ms:.5f} ms, F.silu(F.group_norm) {lib_ms:.5f} ms "
                      f"(graph {lib_graph_ms:.5f}), bound {bound_ms:.5f} ms "
                      f"({bound_by}), {100 * bound_ms / graph_ms:.2f}% of bound "
                      f"in the graph [{card}]")
                del x, got, again, want, xs
    return rows


def phase_norm_op():
    """The op entry a user calls, ``ops.fused_group_norm_silu``, once per
    flagship ResBlock norm shape at batch 4 in bf16: every call launches
    both kernels. Returns the launch count."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    inputs = [_norm_inputs(gen, SERVE_BATCH, H, C, torch.bfloat16)
              for H, C in NORM_SHAPES]
    torch.cuda.synchronize()
    fn.LAUNCHES = 0  # count only the op's main path from here
    with torch.inference_mode():
        outs = [ops.fused_group_norm_silu(x, s, b, NORM_GROUPS)
                for x, s, b in inputs]
    torch.cuda.synchronize()
    launched = fn.LAUNCHES
    for (x, s, b), y in zip(inputs, outs):
        want = fn.group_norm_silu_plain(x, s, b, NORM_GROUPS)
        err = (y.float() - want.float()).abs().max().item()
        tol = NORM_TOL[torch.bfloat16] * max(1.0, want.float().abs().max().item())
        check(y.shape == x.shape and y.dtype == x.dtype, "op output shape/dtype")
        check(torch.isfinite(y).all().item(), "non-finite op output")
        check(err <= tol, f"op {tuple(x.shape)}: error {err} over {tol}")
    print(f"[norm-op] ops.fused_group_norm_silu at {len(inputs)} flagship "
          f"shapes, batch {SERVE_BATCH}, bf16: {launched} kernel launches "
          f"(statistics + apply per call)")
    check(launched == 2 * len(inputs),
          f"{launched} group_norm_silu launches, not {2 * len(inputs)}")
    return launched


def _with_plain_attention(fn):
    """``fn()`` with the models' attention (the U-Nets' AttentionBlock,
    DiT's blocks and the KL-VAE's bottleneck) swapped for the plain
    version."""
    modules = (attention_module, dit_module, vae_module)
    kernel_attention = [m.scaled_attention for m in modules]
    for m in modules:
        m.scaled_attention = fa.reference_attention
    try:
        return fn()
    finally:
        for m, f in zip(modules, kernel_attention):
            m.scaled_attention = f


def _forward_kernel_and_plain(dtype, batch=PARITY_BATCH, image=IMAGE):
    """The full-width flagship DSUNet (weights from SEED) in compute dtype
    ``dtype``, ``batch`` maps of ``image``²: (output with the attention
    kernel, output with plain attention, kernel launches of the first)."""
    params = FLAGSHIP_CONFIG["unet_config"]["params"]
    model = build_model("dsunet", device="cuda", in_channels=4,
                        out_channels=2, dtype=dtype, **params).eval()
    random_params(model, SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(batch, image, image, 4, generator=gen, device="cuda")
    t = torch.tensor([17.0, 803.0], device="cuda")[:batch]
    with torch.inference_mode():
        before = fa.LAUNCHES
        out_kernel, _ = model(x, t)
        launched = fa.LAUNCHES - before
        out_plain, _ = _with_plain_attention(lambda: model(x, t))
    torch.cuda.synchronize()
    return out_kernel.float(), out_plain.float(), launched


def phase_model_parity():
    """Full-width flagship DSUNet, kernel vs plain attention: f32 with TF32
    off (the tf32x3 route), then bf16 (the wgmma route, the serving dtype),
    whose gap to the f32 output is printed as bf16's own noise; last bf16 at
    the adaptive request's size, where every attention tile is partial."""
    disable_tf32()
    out_f32 = None
    for dtype, rtol, batch, image in (
            (torch.float32, MODEL_RTOL, PARITY_BATCH, IMAGE),
            (torch.bfloat16, MODEL_BF16_RTOL, PARITY_BATCH, IMAGE),
            (torch.bfloat16, MODEL_BF16_RTOL, ADAPTIVE_BATCH, ADAPTIVE_IMAGE)):
        out_kernel, out_plain, launched = _forward_kernel_and_plain(
            dtype, batch, image)
        name = str(dtype).split(".")[1]
        err = (out_kernel - out_plain).abs().max().item()
        scale = out_plain.abs().max().item()
        tol = rtol * max(1.0, scale)
        gap = ("" if out_f32 is None or out_f32.shape != out_plain.shape else
               f", bf16 plain vs f32 plain {(out_plain - out_f32).abs().max().item():.3e}")
        print(f"[parity] DSUNet {image}² batch {batch} {name} "
              f"({fa.ROUTES[dtype]} route): max_abs_err {err:.3e} (tol "
              f"{tol:.3e}, max |out| {scale:.3f}{gap}), {launched} kernel "
              f"launches")
        check(torch.isfinite(out_kernel).all().item(), "non-finite model output")
        check(launched == CALLS_PER_FORWARD, f"{launched} attention launches "
              f"in one {name} forward, not {CALLS_PER_FORWARD}")
        check(err <= tol, f"{name} model parity error {err} over {tol}")
        out_f32 = out_plain


def _check_sample(out, batch, image, clipped: bool, what: str) -> None:
    check(out.shape == (batch, image, image, 1),
          f"{what}: output shape {tuple(out.shape)}")
    check(torch.isfinite(out).all().item(), f"{what}: non-finite sample")
    if clipped:
        check(out.abs().max().item() <= 1.0, f"{what}: sample outside [-1, 1]")


def _serve_requests(trainer, what: str, per_request: int, smi: str):
    """SERVE_REQUESTS DDIM requests of batch SERVE_BATCH at 256² through
    ``trainer.sample_fn``, each checked for shape, finiteness, range and
    ``per_request`` attention launches. Returns (launches, walls, peaks,
    (cond, x_T, out) of the first request)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    conds = [torch.randn(SERVE_BATCH, IMAGE, IMAGE, trainer.n_cond,
                         generator=gen, device="cuda")
             for _ in range(SERVE_REQUESTS)]
    torch.cuda.synchronize()
    fa.LAUNCHES = 0  # count only the main path from here
    walls, peaks, first = [], [], None
    for i, cond in enumerate(conds):
        x_T = torch.randn(SERVE_BATCH, IMAGE, IMAGE, 1, generator=gen,
                          device="cuda")
        before = fa.LAUNCHES
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = trainer.sample_fn(cond, gen, x_T)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        launched = fa.LAUNCHES - before
        print(f"[{what}] request {i}: {walls[-1]:.4f} s, "
              f"{SERVE_BATCH / walls[-1]:.3f} slices/s, peak {peaks[-1]:.3f} "
              f"GiB, {launched} attention launches [{smi}]")
        _check_sample(out, SERVE_BATCH, IMAGE, True, what)
        check(launched == per_request,
              f"{launched} attention launches in a request, not {per_request}")
        if first is None:
            first = (cond, x_T, out)
    total = fa.LAUNCHES
    check(total == per_request * SERVE_REQUESTS,
          f"{total} attention launches, not {per_request * SERVE_REQUESTS}")
    return total, walls, peaks, first


def _serving_trainer(config: dict) -> Trainer:
    trainer = Trainer(dict(config), device="cuda")
    random_params(trainer.model, SEED)
    trainer.reset_state()  # the EMA, which sample_fn serves, starts there
    return trainer


def phase_serve(smi: str):
    """Three DDIM-20 requests on the flagship. Returns the trainer, the
    launches, the walls and peaks, and the first request."""
    trainer = _serving_trainer(FLAGSHIP_CONFIG)
    print(f"[serve] DSUNet {trainer.n_params / 1e6:.2f} M params, bf16, "
          f"DDIM-{trainer.rsched.num_timesteps}, batch {SERVE_BATCH}, {IMAGE}²")
    return (trainer,) + _serve_requests(
        trainer, "serve", CALLS_PER_FORWARD * DDIM_STEPS, smi)


def _attention_blocks(module) -> int:
    return sum(isinstance(m, AttentionBlock) for m in module.modules())


def _flax_tree(model) -> dict:
    """``model``'s parameters as a Flax-layout tree of numpy arrays (the
    inverse of ``utils.flax_bridge``, for an unstacked model): conv OIHW ->
    HWIO ``kernel``, Dense [out, in] -> [in, out] ``kernel``, norm weight ->
    ``scale``."""
    tree: dict = {}
    for key, val in model.state_dict().items():
        *mods, leaf = key.split(".")
        arr = val.detach().float().cpu().numpy()
        if leaf == "weight":
            leaf = "kernel" if arr.ndim > 1 else "scale"
            if arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                arr = arr.T
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = arr
    return tree


def _hold(name: str, got, want, launched: int, expected: int) -> None:
    """``got`` within MODEL_RTOL of ``want``'s largest magnitude, and the
    launch count of the run that made it."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    tol = MODEL_RTOL * max(1.0, scale)
    print(f"[split-parity] {name}: max_abs_err {err:.3e} (tol {tol:.3e}, "
          f"max |out| {scale:.3f}), {launched} kernel launches")
    check(torch.isfinite(got).all().item(), f"{name}: non-finite output")
    check(launched == expected,
          f"{name}: {launched} attention launches, not {expected}")
    check(err <= tol, f"{name}: error {err} over {tol}")


def phase_split_parity():
    """Full width, f32 with TF32 off, batch PARITY_BATCH at 256²:
    (a) ``DSUNetSplit.forward`` with the attention kernel against the same
    with plain attention; (b) ``denoise_cached`` against ``forward`` where
    they must agree: at t == t_ref, and with ``cond_t_ref`` set at t != t_ref;
    (c) a stacked-layout (``stream_mode='vmap'``) DSUNet, loaded from the
    sequential model's weights through ``convert_stream_layout``, against
    the sequential forward."""
    disable_tf32()
    params = FLAGSHIP_CONFIG["unet_config"]["params"]
    kw = dict(device="cuda", in_channels=4, out_channels=2,
              dtype=torch.float32, **params)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = torch.randn(PARITY_BATCH, IMAGE, IMAGE, 4, generator=gen, device="cuda")
    t = torch.tensor([17.0, 803.0], device="cuda")

    def counted(fn):
        before = fa.LAUNCHES
        out = fn()
        torch.cuda.synchronize()
        return out, fa.LAUNCHES - before

    with torch.inference_mode():
        split = random_params(build_model("dsunet_split", **kw).eval(), SEED)
        check(_attention_blocks(split.noise_encoder) == ENCODER_ATTN
              and _attention_blocks(split.middle) == MIDDLE_ATTN
              and _attention_blocks(split.decoder) == DECODER_ATTN
              and _attention_blocks(split) == CALLS_PER_FORWARD,
              "the split model's attention blocks are not 4 x 6 + 1 + 9")
        (full, _), launched = counted(lambda: split(x, t))
        plain, _ = _with_plain_attention(lambda: split(x, t))
        _hold("(a) DSUNetSplit forward, kernel vs plain attention", full,
              plain, launched, CALLS_PER_FORWARD)

        cond, x_noise = x[..., 1:], x[..., :1]
        cache, launched = counted(lambda: split.encode_conditions(cond, t))
        check(launched == ENCODE_CALLS,
              f"{launched} launches in encode_conditions, not {ENCODE_CALLS}")
        (cached, _), launched = counted(
            lambda: split.denoise_cached(x_noise, t, cache))
        _hold("(b) denoise_cached vs forward at t == t_ref", cached, full,
              launched, CACHED_STEP_CALLS)
        split.cond_t_ref = 500.0
        pinned, _ = split(x, t)
        cache = split.encode_conditions(cond, torch.full_like(t, 77.0))
        (cached, _), launched = counted(
            lambda: split.denoise_cached(x_noise, t, cache))
        _hold("(b) denoise_cached vs forward, cond_t_ref 500, t != t_ref",
              cached, pinned, launched, CACHED_STEP_CALLS)
        check((pinned - full).abs().max().item() > 0,
              "cond_t_ref changed nothing")
        del split, cache, cached, pinned, full, plain

        seq = random_params(build_model("dsunet", **kw).eval(), SEED)
        want, _ = seq(x, t)
        tree = _flax_tree(seq)
        del seq
        stacked = build_model("dsunet", stream_mode="vmap", **kw).eval()
        stacked.load_state_dict(
            flax_to_state_dict(convert_stream_layout(tree), stacked))
        check(stacked.encoders.in_conv.weight.shape[0] == 4,
              "the stacked layout has no stream axis of 4")
        (got, _), launched = counted(lambda: stacked(x, t))
        _hold("(c) stacked-layout DSUNet vs sequential", got, want, launched,
              CALLS_PER_FORWARD)


def phase_serve_cached(smi: str, flagship_walls, flagship_peaks):
    """Three DDIM-20 requests on ``net_mode: ds_diff_split`` through the
    cached-condition sampler. Returns the attention launches."""
    trainer = _serving_trainer(SPLIT_CONFIG)
    check(trainer.model_name == "dsunet_split", "not the split model")
    print(f"[serve-cached] DSUNetSplit {trainer.n_params / 1e6:.2f} M params, "
          f"bf16, cached-condition DDIM-{trainer.rsched.num_timesteps}, batch "
          f"{SERVE_BATCH}, {IMAGE}²: {ENCODE_CALLS} launches to encode the "
          f"conditions + {CACHED_STEP_CALLS} a step")
    total, walls, peaks, _ = _serve_requests(
        trainer, "serve-cached", CACHED_REQUEST_CALLS, smi)
    for i, (w, fw) in enumerate(zip(walls, flagship_walls)):
        print(f"[serve-cached] request {i}: cached {w:.4f} s "
              f"({SERVE_BATCH / w:.3f} slices/s, peak {peaks[i]:.3f} GiB) vs "
              f"flagship {fw:.4f} s ({SERVE_BATCH / fw:.3f} slices/s, peak "
              f"{flagship_peaks[i]:.3f} GiB): {fw / w:.3f}x [{smi}]")
    return total


def phase_serve_samplers(trainer, first, smi: str):
    """On the flagship trainer of ``phase_serve``: one 20-step request
    through each other sampler, set by ``Trainer.set_sampler``; the adaptive
    solver at a small size; then DDIM again on the first request's inputs.
    Returns the attention launches."""
    cond, x_T, first_out = first
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    calls = []
    hook = trainer.sample_model.register_forward_hook(
        lambda *_: calls.append(1))
    torch.cuda.synchronize()
    fa.LAUNCHES = 0  # count only the main path from here

    def request(cond, x_T, what, clipped):
        calls.clear()
        before = fa.LAUNCHES
        t0 = time.perf_counter()
        out = trainer.sample_fn(cond, gen, x_T)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = fa.LAUNCHES - before
        print(f"[serve-samplers] {what}: {wall:.4f} s, {len(calls)} model "
              f"calls, {launched} attention launches, max |x| "
              f"{out.abs().max().item():.4f} [{smi}]")
        _check_sample(out, cond.shape[0], cond.shape[1], clipped, what)
        check(launched == CALLS_PER_FORWARD * len(calls),
              f"{what}: {launched} launches for {len(calls)} model calls")
        return out

    try:
        for name, model_calls in SAMPLER_MODEL_CALLS:
            trainer.set_sampler(name, sample_steps=DDIM_STEPS)
            # the DPM-Solver family never clips
            request(cond, x_T, f"{name}-{DDIM_STEPS}",
                    name in ("dpm++", "plms", "ancestral"))
            check(len(calls) == model_calls,
                  f"{name}: {len(calls)} model calls, not {model_calls}")
        trainer.set_sampler("dpm_adaptive")
        small = torch.randn(ADAPTIVE_BATCH, ADAPTIVE_IMAGE, ADAPTIVE_IMAGE,
                            trainer.n_cond, generator=gen, device="cuda")
        request(small, None, f"dpm_adaptive, batch {ADAPTIVE_BATCH}, "
                f"{ADAPTIVE_IMAGE}²", False)
        check(len(calls) >= 3 and len(calls) % 3 == 0,
              f"dpm_adaptive made {len(calls)} model calls")
        trainer.set_sampler("ddim", sample_steps=DDIM_STEPS)
        again = request(cond, x_T, f"ddim-{DDIM_STEPS} again", True)
    finally:
        hook.remove()
    err = (again - first_out).abs().max().item()
    tol = MODEL_BF16_RTOL * max(1.0, first_out.abs().max().item())
    print(f"[serve-samplers] ddim after the switches vs the first request: "
          f"max_abs_err {err:.3e} (tol {tol:.3e}), bit for bit: "
          f"{torch.equal(again, first_out)}")
    check(err <= tol, f"ddim does not reproduce the first request: {err}")
    return fa.LAUNCHES


def _flagship_task() -> TaskConfig:
    return TaskConfig(parameterization="v", loss_type="charbonnier",
                      learn_sigma=True, feature_kind="ds",
                      disentangle_mode="eu", disen_lambda=0.5)


def phase_train_parity():
    """Full-width flagship DSUNet in f32 with TF32 off and remat on, batch 2
    at 256², on the flagship's ``linear`` noise schedule: the train
    objective and every parameter gradient with the attention kernel (its
    tf32x3 route) against the same with plain attention."""
    disable_tf32()
    params = FLAGSHIP_CONFIG["unet_config"]["params"]
    model = build_model("dsunet", device="cuda", in_channels=4,
                        out_channels=2, dtype=torch.float32, remat=True,
                        **params).train()
    random_params(model, SEED)
    sched = schedules.DiffusionSchedule.create(
        schedules.make_beta_schedule(
            FLAGSHIP_CONFIG["noise_schedule"],
            FLAGSHIP_CONFIG["diffusion_steps"],
            FLAGSHIP_CONFIG["linear_start"], FLAGSHIP_CONFIG["linear_end"]),
        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    B = PARITY_BATCH
    x0 = torch.rand(B, IMAGE, IMAGE, 1, generator=gen, device="cuda") * 2 - 1
    cond = torch.randn(B, IMAGE, IMAGE, 3, generator=gen, device="cuda")
    noise = torch.randn(B, IMAGE, IMAGE, 1, generator=gen, device="cuda")
    t = torch.tensor([17, 803], device="cuda")
    weights = torch.ones(B, device="cuda")
    task = _flagship_task()

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss, _, _ = train_loss(task, sched, model, x0, cond, t, noise, weights)
        loss.backward()
        return loss.item(), [torch.zeros_like(p) if p.grad is None
                             else p.grad.detach().clone()
                             for p in model.parameters()]

    before = fa.LAUNCHES
    loss_k, grads_k = loss_and_grads()
    launched = fa.LAUNCHES - before
    loss_p, grads_p = _with_plain_attention(loss_and_grads)
    torch.cuda.synchronize()
    names = [n for n, _ in model.named_parameters()]
    top = max(g.abs().max().item() for g in grads_p)
    worst, worst_name = 0.0, ""
    for name, gk, gp in zip(names, grads_k, grads_p):
        scale = max(gp.abs().max().item(), GRAD_NOISE_FLOOR * top)
        rel = (gk - gp).abs().max().item() / scale
        if rel > worst:
            worst, worst_name = rel, name
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"[train-parity] DSUNet 256² batch {B} f32 remat: loss {loss_k:.6f} "
          f"vs {loss_p:.6f} (rel {loss_rel:.3e}, tol {TRAIN_LOSS_RTOL:.0e}); "
          f"worst gradient error {worst:.3e} of its leaf's scale at "
          f"{worst_name} (tol {TRAIN_GRAD_RTOL:.0e}, {len(names)} leaves); "
          f"{launched} kernel launches")
    check(all(torch.isfinite(g).all().item() for g in grads_k),
          "non-finite gradient")
    check(launched == CALLS_PER_FORWARD,
          f"{launched} attention launches in one train forward, not "
          f"{CALLS_PER_FORWARD}")
    check(loss_rel <= TRAIN_LOSS_RTOL, f"loss parity {loss_rel}")
    check(worst <= TRAIN_GRAD_RTOL, f"gradient parity {worst} at {worst_name}")
    del model, grads_k, grads_p


def phase_train(smi: str):
    """``Trainer.train_step`` on the flagship config, bf16 compute over f32
    master weights with remat, batch 8 at 256²; then one DDIM-20 request
    from the EMA weights. Returns the attention launches of the train steps
    and of the request."""
    torch.backends.cudnn.allow_tf32 = True  # the default a user trains with
    trainer = Trainer(dict(FLAGSHIP_CONFIG), device="cuda")
    random_params(trainer.model, SEED)
    trainer.reset_state()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    B = TRAIN_BATCH
    batch = {
        "target": torch.rand(B, IMAGE, IMAGE, 1, generator=gen,
                             device="cuda") * 2 - 1,
        "image": torch.randn(B, IMAGE, IMAGE, trainer.n_cond, generator=gen,
                             device="cuda"),
    }
    leaf = "decoder.up_0_0_res.in_conv.weight"
    index = trainer.state.names.index(leaf)
    p0 = trainer.state.params[index].detach().clone()
    start = [p.detach().clone() for p in trainer.state.params]
    print(f"[train] DSUNet {trainer.n_params / 1e6:.2f} M params, f32 master "
          f"weights, bf16 compute, remat {trainer.model.encoder_0.remat}, "
          f"batch {B}, {IMAGE}²")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0  # count only the main path from here
    times = []
    for i in range(TRAIN_STEPS):
        before = fa.LAUNCHES
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launched = fa.LAUNCHES - before
        vals = {k: v.item() for k, v in metrics.items()}
        print(f"[train] step {i + 1}: {times[-1] * 1e3:.2f} ms, "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(vals.items()))
              + f", {launched} attention launches")
        check(all(math.isfinite(v) for v in vals.values()),
              f"non-finite metric at step {i + 1}: {vals}")
        check(vals["grad_norm"] > 0, "zero gradient norm")
        check(launched == CALLS_PER_FORWARD,
              f"{launched} attention launches in a train step, not "
              f"{CALLS_PER_FORWARD}")
        if i == 0:
            p1 = trainer.state.params[index].detach()
            want = 0.1 * p0 + 0.9 * p1
            got = trainer.state.ema[index]
            ema_err = ((got - want).abs().max() / want.abs().max()).item()
            print(f"[train] EMA after step 1 on {leaf}: max error "
                  f"{ema_err:.3e} of max |0.1 p0 + 0.9 p1| (tol {EMA_RTOL:.0e})")
            check(ema_err <= EMA_RTOL, f"EMA after step 1: {ema_err}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    train_launches = fa.LAUNCHES
    moved = sum(not torch.equal(a, p) for a, p in zip(start, trainer.state.params))
    check(moved > 0, "no parameter moved")
    step_ms = statistics.median(times[1:]) * 1e3
    print(f"[train] step {step_ms:.2f} ms (median of steps 2-{TRAIN_STEPS}), "
          f"{B / step_ms * 1e3:.3f} slices/s, peak {peak:.3f} GiB, "
          f"{moved}/{len(start)} parameter tensors moved [{smi}]")
    del start

    # serve one request from the EMA weights and score it
    cond, target = batch["image"][:SERVE_BATCH], batch["target"][:SERVE_BATCH]
    before = fa.LAUNCHES
    t0 = time.perf_counter()
    out = trainer.sample_fn(cond, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = fa.LAUNCHES - before
    val = {k: v.item() for k, v in trainer.val_metrics(out, target).items()}
    print(f"[train] DDIM-{DDIM_STEPS} request from the EMA weights: "
          f"{wall:.4f} s, {launched} attention launches; val_metrics "
          + ", ".join(f"{k} {v:.6f}" for k, v in sorted(val.items())))
    per_request = CALLS_PER_FORWARD * DDIM_STEPS
    check(out.shape == (SERVE_BATCH, IMAGE, IMAGE, 1) and
          torch.isfinite(out).all().item(), "bad sample from the EMA weights")
    check(launched == per_request,
          f"{launched} attention launches in a request, not {per_request}")
    check(all(math.isfinite(v) for v in val.values()), f"val metrics {val}")
    check(val["ssim"] <= 1.0, f"SSIM {val['ssim']} above 1")
    return train_launches, launched


def _fit_config(root: Path) -> dict:
    cfg = dict(FLAGSHIP_CONFIG)
    cfg.update(h5_2d_img_dir=str(root), data_store="npy", train_keys=FIT_KEYS,
               **{k: cut for k, (_, cut) in FIT_CUTS.items()})
    return cfg


def _write_ground_truth(root: Path, gt_root: Path) -> list:
    """The test cases' target volumes [H, W, S] as NIfTI, written with the
    port's own codec; returns the case names."""
    split = root / f"images_ts_{IMAGE}"
    cases = sorted(p.name for p in split.iterdir())
    for case in cases:
        stack = np.load(split / case / f"{FIT_KEYS[-1]}.npy")  # [S, H, W]
        (gt_root / case).mkdir(parents=True)
        write_nifti(gt_root / case / f"{FIT_KEYS[-1]}.nii.gz",
                    Nifti(np.ascontiguousarray(stack.transpose(1, 2, 0))))
    return cases


class _Meter:
    """Wraps a trainer's ``train_step``, ``sample_fn`` and checkpoint
    ``save``: each call is synchronised, timed and its attention launches
    counted."""

    def __init__(self, trainer):
        self.steps, self.samples, self.saves = [], [], []
        for owner, name, log in ((trainer, "train_step", self.steps),
                                 (trainer, "sample_fn", self.samples),
                                 (trainer.ckpt, "save", self.saves)):
            setattr(owner, name, self._wrap(getattr(owner, name), log))

    @staticmethod
    def _wrap(fn, log):
        def timed(*args, **kw):
            before = fa.LAUNCHES
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            log.append((time.perf_counter() - t0, fa.LAUNCHES - before))
            return out
        return timed


def _state_equal(a: Trainer, b: Trainer) -> list:
    """Names of whatever differs between two trainers' train and sampler
    states, bit for bit."""
    sa, sb = a.state.state_dict(), b.state.state_dict()
    diff = [k for k in sa if not isinstance(sa[k], dict) and sa[k] != sb[k]]
    for group, tensors in sa.items():
        if isinstance(tensors, dict):
            diff += [f"{group}/{n}" for n, t in tensors.items()
                     if not torch.equal(t, sb[group][n])]
    for buf in ("loss_history", "loss_counts"):
        if not torch.equal(getattr(a.sampler_state, buf),
                           getattr(b.sampler_state, buf)):
            diff.append(f"sampler/{buf}")
    return diff


def phase_fit(smi: str):
    """The flagship on data through its entry points: ``fit`` (3 steps at
    batch 32, one validation, one save), a bit-exact restore into a second
    trainer that resumes ``fit`` at epoch 1, then ``predict`` with the
    metric report. Returns the attention launches of train steps,
    validation and predict."""
    torch.backends.cudnn.allow_tf32 = True  # the default a user trains with
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_fit_"))
    try:
        return _fit(tmp, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _fit(tmp: Path, smi: str):
    root, workdir, gt_root = tmp / "data", tmp / "run", tmp / "gt"
    t0 = time.perf_counter()
    synthetic.make_structured_dataset(root, n_cases=FIT_CASES,
                                      n_slices=FIT_SLICES, hw=IMAGE, seed=SEED,
                                      store="npy")
    cases = _write_ground_truth(root, gt_root)
    print(f"[fit] synthetic npy store, {FIT_CASES} cases x {FIT_SLICES} "
          f"slices at {IMAGE}², and {len(cases)} NIfTI ground truths in "
          f"{time.perf_counter() - t0:.2f} s")
    print("[fit] cuts: " + ", ".join(f"{k} {a} -> {b}"
                                     for k, (a, b) in FIT_CUTS.items())
          + " (matplotlib is not installed on the card's machine); "
          "train_keys are the synthetic store's A, B, C -> GT")
    cfg = _fit_config(root)
    check(len(cases) == FIT_TEST_CASES, f"{len(cases)} test cases")

    trainer = Trainer(cfg, workdir, device="cuda")
    check(len(trainer.train_loader) == FIT_STEPS_PER_EPOCH,
          f"{len(trainer.train_loader)} train batches an epoch")
    meter = _Meter(trainer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0  # count only the main path from here
    t0 = time.perf_counter()
    step = trainer.fit(num_epochs=1, log_every=1, val_every_epochs=1)
    fit_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    build = trainer.train_loader.build_seconds
    check(step == FIT_STEPS_PER_EPOCH, f"fit ended at step {step}")
    check(trainer.ckpt.all_steps() == [step],
          f"checkpoints {trainer.ckpt.all_steps()}")
    saved = json.loads((workdir / "checkpoint" / str(step)
                        / "metrics.json").read_text())
    check(set(saved) == {"val_ssim", "val_mae"} and all(
        math.isfinite(v) for v in saved.values()), f"saved metrics {saved}")
    walls = [w for w, _ in meter.steps]
    step_s = statistics.median(walls[1:])
    print(f"[fit] {step} steps at batch {FIT_BATCH}: " + ", ".join(
        f"{w * 1e3:.2f} ms ({n} attention launches)" for w, n in meter.steps)
          + f"; median of steps 2-{step} {step_s * 1e3:.2f} ms, "
          f"{FIT_BATCH / step_s:.3f} slices/s; loader {statistics.median(build) * 1e3:.2f} "
          f"ms a batch ({statistics.median(build) / FIT_BATCH * 1e3:.3f} ms a "
          f"slice, {len(build)} batches, its own thread); peak {peak:.3f} GiB "
          f"[{smi}]")
    val_wall, val_launches = meter.samples[0]
    print(f"[fit] validate: {len(meter.samples)} DDIM-{DDIM_STEPS} batch of "
          f"{VAL_BATCH} in {val_wall:.4f} s, {val_launches} attention "
          f"launches; saved step {step} with {saved} in "
          f"{meter.saves[0][0]:.2f} s; fit {fit_wall:.2f} s [{smi}]")
    for w, n in meter.steps:
        check(n == CALLS_PER_FORWARD,
              f"{n} attention launches in a train step, not {CALLS_PER_FORWARD}")
    check(len(meter.samples) == 1 and val_launches == CALLS_PER_FORWARD
          * DDIM_STEPS, f"validation launches {meter.samples}")
    launches = {"fit_train": sum(n for _, n in meter.steps),
                "fit_validate": val_launches}

    # a second trainer on the workdir: restore, then resume
    resumed = Trainer(cfg, workdir, device="cuda")
    t0 = time.perf_counter()
    resumed.state, resumed.sampler_state = resumed.ckpt.restore(
        resumed.state, resumed.sampler_state)
    restore_s = time.perf_counter() - t0
    diff = _state_equal(trainer, resumed)
    print(f"[fit] restored step {resumed.state.step} in {restore_s:.2f} s: "
          f"{len(resumed.state.names)} parameters, EMA tensors and AdamW "
          f"moments, count {resumed.state.tx.count} and the sampler buffers "
          f"bit for bit: {not diff}")
    check(not diff, f"the restored state differs at {diff[:4]}")
    del trainer
    meter = _Meter(resumed)
    step = resumed.fit(num_epochs=2, log_every=1, val_every_epochs=1)
    rows = [json.loads(line) for line in
            (workdir / "logs" / "progress.jsonl").read_text().splitlines()]
    resumed_rows = [(int(r["step"]), int(r["epoch"])) for r in rows
                    if "step" in r][FIT_STEPS_PER_EPOCH:]
    print(f"[fit] resumed: (step, epoch) {resumed_rows}, checkpoints "
          f"{resumed.ckpt.all_steps()}, steps " + ", ".join(
              f"{w * 1e3:.2f} ms" for w, _ in meter.steps) + f" [{smi}]")
    check(resumed_rows == [(s, 1) for s in range(FIT_STEPS_PER_EPOCH + 1,
                                                  2 * FIT_STEPS_PER_EPOCH + 1)],
          f"the resumed fit logged {resumed_rows}")
    check(step == 2 * FIT_STEPS_PER_EPOCH and resumed.ckpt.all_steps()
          == [FIT_STEPS_PER_EPOCH, step], "resumed fit's steps or saves")
    check(all(n == CALLS_PER_FORWARD for _, n in meter.steps),
          f"resumed train step launches {meter.steps}")
    launches["fit_train"] += sum(n for _, n in meter.steps)
    launches["fit_validate"] += sum(n for _, n in meter.samples)

    # predict every test slice, assemble volumes, score them
    meter.samples.clear()
    t0 = time.perf_counter()
    out_dir, metric_rows = resumed.predict(template_root=gt_root,
                                           gt_root=gt_root)
    predict_wall = time.perf_counter() - t0
    sample_wall = sum(w for w, _ in meter.samples)
    preds = sorted(out_dir.glob("*_pred.nii.gz"))
    n_batches = -(-FIT_TEST_CASES * FIT_SLICES // VAL_BATCH)
    print(f"[fit] predict: {len(meter.samples)} DDIM-{DDIM_STEPS} batches of "
          f"{VAL_BATCH} in {sample_wall:.4f} s "
          f"({FIT_TEST_CASES * FIT_SLICES / sample_wall:.3f} slices/s), "
          f"{sum(n for _, n in meter.samples)} attention launches; "
          f"{len(preds)} volumes, metric report {predict_wall - sample_wall:.2f} "
          f"s, predict {predict_wall:.2f} s [{smi}]")
    for r in metric_rows:
        print("[fit] metrics " + ", ".join(
            f"{k} {v:.4f}" if k != "case" else v for k, v in r.items()))
    check(len(meter.samples) == n_batches and all(
        n == CALLS_PER_FORWARD * DDIM_STEPS for _, n in meter.samples),
          f"predict batches and launches {meter.samples}")
    check(len(preds) == FIT_TEST_CASES, f"{len(preds)} predicted volumes")
    for p in preds:
        vol = read_nifti(p).data
        check(vol.shape == (IMAGE, IMAGE, FIT_SLICES)
              and np.isfinite(vol).all(), f"{p.name}: {vol.shape}")
    check(len(metric_rows) == FIT_TEST_CASES and all(
        math.isfinite(v) for r in metric_rows for k, v in r.items()
        if k != "case"), "non-finite or missing metric rows")
    check((out_dir / "metrics.csv").exists(), "no metrics.csv")
    launches["predict"] = sum(n for _, n in meter.samples)
    return launches


def family_config(net_mode: str, model_yaml: str):
    """configs/train_config.yaml merged with a family's model config, as a
    user runs it."""
    return load_run_config(CONFIGS / "train_config.yaml", CONFIGS / model_yaml,
                           overrides={"net_mode": net_mode})


def _family_parity(cfg, calls: int, tag: str = "families") -> None:
    """A family's model at full width, batch PARITY_BATCH at 256², with the
    attention kernel against plain attention: f32 with TF32 off, then bf16,
    each within its tolerance of the output's largest magnitude, and
    ``calls`` kernel launches a forward."""
    disable_tf32()
    net_mode = cfg["net_mode"]
    name, _ = FEATURE_KINDS[net_mode]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for dtype, rtol in ((torch.float32, MODEL_RTOL),
                        (torch.bfloat16, MODEL_BF16_RTOL)):
        params = dict(model_params(cfg, name, len(cfg["train_keys"]) - 1),
                      dtype=dtype)
        model = random_params(build_model(name, device="cuda", **params),
                              SEED).eval()
        x = torch.randn(PARITY_BATCH, IMAGE, IMAGE, 4, generator=gen,
                        device="cuda")
        t = torch.tensor([17.0, 803.0], device="cuda")

        def forward():
            out = model(x, t)
            return (out[0] if isinstance(out, tuple) else out).float()

        with torch.inference_mode():
            before = fa.LAUNCHES
            out_kernel = forward()
            torch.cuda.synchronize()
            launched = fa.LAUNCHES - before
            out_plain = _with_plain_attention(forward)
        torch.cuda.synchronize()
        err = (out_kernel - out_plain).abs().max().item()
        scale = out_plain.abs().max().item()
        tol = rtol * max(1.0, scale)
        dname = str(dtype).split(".")[1]
        print(f"[{tag}] {net_mode} {type(model).__name__} {IMAGE}² batch "
              f"{PARITY_BATCH} {dname} ({fa.ROUTES[dtype]} route): "
              f"max_abs_err {err:.3e} (tol {tol:.3e}, max |out| "
              f"{scale:.3f}), {launched} kernel launches")
        check(torch.isfinite(out_kernel).all().item(),
              f"{net_mode} {dname}: non-finite output")
        check(launched == calls, f"{net_mode} {dname}: {launched} attention "
              f"launches in a forward, not {calls}")
        check(err <= tol, f"{net_mode} {dname} parity error {err} over {tol}")
        del model, out_kernel, out_plain


def _family_request(trainer, calls: int, smi: str,
                    tag: str = "families") -> int:
    """One request of batch SERVE_BATCH at 256² through
    ``trainer.sample_fn``: shape, finite values, ``calls`` launches a model
    call, and (for the samplers that end on a clipped x0) the range [-1, 1].
    Returns the launches."""
    net_mode = trainer.cfg["net_mode"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    cond = torch.randn(SERVE_BATCH, IMAGE, IMAGE, trainer.n_cond,
                       generator=gen, device="cuda")
    model_calls = []
    hook = trainer.sample_model.register_forward_hook(
        lambda *_: model_calls.append(1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0  # count only the main path from here
    try:
        t0 = time.perf_counter()
        out = trainer.sample_fn(cond, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        hook.remove()
    launched = fa.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2**30
    sampler = (f"palette DDIM-{trainer.sample_steps} eta {trainer.eta}"
               if trainer.palette else
               f"{trainer.sampler_name.upper()}-{trainer.rsched.num_timesteps}")
    print(f"[{tag}] {net_mode} request, {sampler}, batch {SERVE_BATCH}, "
          f"{IMAGE}²: {wall:.4f} s, {SERVE_BATCH / wall:.3f} slices/s, peak "
          f"{peak:.3f} GiB, {len(model_calls)} model calls, {launched} "
          f"attention launches, max |x| {out.abs().max().item():.4f} [{smi}]")
    # palette's DDIM adds sigma z after its last clipped x0 (eta 1): its
    # samples may pass 1 by that noise, as the JAX package's do
    _check_sample(out, SERVE_BATCH, IMAGE, not trainer.palette,
                  f"{net_mode} request")
    check(len(model_calls) == trainer.sample_steps,
          f"{net_mode}: {len(model_calls)} model calls, not "
          f"{trainer.sample_steps}")
    check(launched == calls * len(model_calls),
          f"{net_mode}: {launched} launches for {len(model_calls)} model calls")
    return launched


def _family_train(trainer, calls: int, smi: str,
                  tag: str = "families") -> int:
    """FAMILY_TRAIN_STEPS bf16 train steps at batch TRAIN_BATCH, 256²,
    through ``trainer.train_step`` from random weights: finite metrics (the
    com/dist loss for disc_diff), ``calls`` launches a step, the EMA after
    step 1, every parameter tensor moved. Returns the launches."""
    torch.backends.cudnn.allow_tf32 = True  # the default a user trains with
    net_mode = trainer.cfg["net_mode"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    batch = {
        "target": torch.rand(TRAIN_BATCH, IMAGE, IMAGE, 1, generator=gen,
                             device="cuda") * 2 - 1,
        "image": torch.randn(TRAIN_BATCH, IMAGE, IMAGE, trainer.n_cond,
                             generator=gen, device="cuda"),
    }
    start = [p.detach().clone() for p in trainer.state.params]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0  # count only the main path from here
    times = []
    for i in range(FAMILY_TRAIN_STEPS):
        before = fa.LAUNCHES
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launched = fa.LAUNCHES - before
        vals = {k: v.item() for k, v in metrics.items()}
        print(f"[{tag}] {net_mode} train step {i + 1}: "
              f"{times[-1] * 1e3:.2f} ms, "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(vals.items()))
              + f", {launched} attention launches")
        check(all(math.isfinite(v) for v in vals.values()),
              f"{net_mode}: non-finite metric at step {i + 1}: {vals}")
        check(vals["grad_norm"] > 0, f"{net_mode}: zero gradient norm")
        if net_mode == "disc_diff":
            check("loss_disen" in vals, "disc_diff: no loss_disen")
        check(launched == calls, f"{net_mode}: {launched} attention launches "
              f"in a train step, not {calls}")
        if i == 0:
            worst = 0.0
            for p0, p1, ema in zip(start, trainer.state.params,
                                   trainer.state.ema):
                want = 0.1 * p0 + 0.9 * p1.detach()
                scale = want.abs().max().item()
                if scale > 0:
                    worst = max(worst,
                                (ema - want).abs().max().item() / scale)
            print(f"[{tag}] {net_mode} EMA after step 1: max error "
                  f"{worst:.3e} of each tensor's max |0.1 p0 + 0.9 p1| (tol "
                  f"{EMA_RTOL:.0e})")
            check(worst <= EMA_RTOL, f"{net_mode} EMA after step 1: {worst}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = sum(not torch.equal(a, p)
                for a, p in zip(start, trainer.state.params))
    step_ms = statistics.median(times[1:]) * 1e3
    print(f"[{tag}] {net_mode} train step {step_ms:.2f} ms (median of "
          f"steps 2-{FAMILY_TRAIN_STEPS}), {TRAIN_BATCH / step_ms * 1e3:.3f} "
          f"slices/s, peak {peak:.3f} GiB, {moved}/{len(start)} parameter "
          f"tensors moved [{smi}]")
    check(moved == len(start), f"{net_mode}: only {moved} of {len(start)} "
          f"parameter tensors moved")
    return fa.LAUNCHES


def phase_families(smi: str) -> dict:
    """Each family at its config's full width: forward parity, one request,
    three train steps. Returns the attention launches by path."""
    launches = {}
    for net_mode, model_yaml, shapes in FAMILIES:
        t0 = time.perf_counter()
        calls = sum(c for *_, c in shapes)
        cfg = family_config(net_mode, model_yaml)
        _family_parity(cfg, calls)
        trainer = _serving_trainer(cfg)
        print(f"[families] {net_mode}: {type(trainer.model).__name__} "
              f"{trainer.n_params / 1e6:.2f} M params, bf16, {calls} "
              f"attention calls a forward")
        launches[f"{net_mode}_serve"] = _family_request(trainer, calls, smi)
        launches[f"{net_mode}_train"] = _family_train(trainer, calls, smi)
        del trainer
        torch.cuda.empty_cache()
        print(f"[families] {net_mode} done in {time.perf_counter() - t0:.1f} s")
    return launches

def latent_configs(root: Path, workdir: Path):
    """configs/autoencoder_kl.yaml and configs/train_config.yaml +
    latent.yaml, as a user runs them, on the synthetic npy store ``root``
    with VAE_CUTS and LATENT_CUTS; the latent run's ``vae_checkpoint`` is
    the VAE run's checkpoint directory under ``workdir``."""
    data = dict(h5_2d_img_dir=str(root), data_store="npy", train_keys=FIT_KEYS,
                seed=SEED)
    vae = load_run_config(CONFIGS / "autoencoder_kl.yaml", overrides=dict(
        data, result_path=str(workdir),
        **{k: cut for k, (_, cut) in VAE_CUTS.items()}))
    latent = load_run_config(
        CONFIGS / "train_config.yaml", CONFIGS / "latent.yaml",
        overrides=dict(data, vae_checkpoint=str(workdir / "vae" / "checkpoint"),
                       **{k: cut for k, (_, cut) in LATENT_CUTS.items()}))
    return vae, latent


def _latent_kernel_rows(card: str) -> list:
    """Kernel vs plain, timed, at the VAE's [B, 1024, 1, 512] and the
    latent UNet's three shapes, at B = 4 (a request's) and 8 (the VAE
    trainer's, the latent trainer's and its validation's), in both
    dtypes."""
    disable_tf32()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for batch in LATENT_KERNEL_BATCHES:
            rows.append(dict(_attention_row(gen, batch, *VAE_ATTENTION, dtype,
                                            None, card), latent="vae"))
            for N, H, D, calls in LATENT_ATTENTION_CALLS:
                rows.append(dict(_attention_row(gen, batch, N, H, D, dtype,
                                                calls, card), latent="unet"))
    return rows


def _latent_parity(latent_cfg) -> None:
    """Full width, kernel vs plain attention, f32 with TF32 off and bf16:
    the KL-VAE's encode (moments) and decode at batch PARITY_BATCH, 256²,
    one launch each, and the latent UNet forward on 32² latents, 16
    launches; each within its tolerance of the output's largest
    magnitude."""
    disable_tf32()
    fs = dict(latent_cfg.get_path("first_stage.params"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    x = torch.rand(PARITY_BATCH, IMAGE, IMAGE, 1, generator=gen,
                   device="cuda") * 2 - 1
    lat = IMAGE // 8
    z = torch.randn(PARITY_BATCH, lat, lat, fs["embed_dim"], generator=gen,
                    device="cuda")
    zx = torch.randn(PARITY_BATCH, lat, lat, 4 * fs["embed_dim"],
                     generator=gen, device="cuda")
    t = torch.tensor([17.0, 803.0], device="cuda")
    for dtype, rtol in ((torch.float32, MODEL_RTOL),
                        (torch.bfloat16, MODEL_BF16_RTOL)):
        vae = random_params(build_model("autoencoder_kl", device="cuda",
                                        dtype=dtype, **fs), SEED).eval()
        params = dict(model_params(latent_cfg, "unet", LATENT_N_COND),
                      dtype=dtype)
        unet = random_params(build_model("unet", device="cuda", **params),
                             SEED).eval()
        runs = (("AutoencoderKL encode (mean, logvar)",
                 lambda: _moments(vae, x), 1),
                ("AutoencoderKL decode", lambda: vae.decode(z), 1),
                ("latent UNet", lambda: unet(zx, t), LATENT_CALLS_PER_FORWARD))
        name = str(dtype).split(".")[1]
        for what, fn, calls in runs:
            with torch.inference_mode():
                before = fa.LAUNCHES
                got = fn().float()
                torch.cuda.synchronize()
                launched = fa.LAUNCHES - before
                want = _with_plain_attention(fn).float()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            tol = rtol * max(1.0, scale)
            print(f"[latent] {what} {name} ({fa.ROUTES[dtype]} route): "
                  f"max_abs_err {err:.3e} (tol {tol:.3e}, max |out| "
                  f"{scale:.3f}), {launched} kernel launches")
            check(torch.isfinite(got).all().item(),
                  f"{what} {name}: non-finite output")
            check(launched == calls, f"{what} {name}: {launched} attention "
                  f"launches, not {calls}")
            check(err <= tol, f"{what} {name}: parity error {err} over {tol}")
        del vae, unet
        torch.cuda.empty_cache()


def _moments(vae, x):
    """The posterior's mean and log-variance, stacked."""
    post = vae.encode(x)
    return torch.stack([post.mean, post.logvar])


def _vae_train(vae_cfg, workdir: Path, smi: str) -> dict:
    """``VaeTrainer`` at the config's batch: VAE_TRAIN_STEPS GAN steps
    through ``fit`` (disc_start cut to 0: the generator term and the disc
    step run from the first step), every parameter of both networks moved,
    d_weight finite, VAE_STEP_CALLS launches a step, a checkpoint, then
    ``reconstruction_metrics``. Returns the launches."""
    torch.backends.cudnn.allow_tf32 = True  # the default a user trains with
    trainer = VaeTrainer(vae_cfg, workdir / "vae", device="cuda")
    n_vae = sum(p.numel() for p in trainer.vae.parameters())
    n_disc = sum(p.numel() for p in trainer.disc.parameters())
    print(f"[latent] VaeTrainer: AutoencoderKL {n_vae / 1e6:.2f} M params, "
          f"PatchDiscriminator {n_disc / 1e6:.2f} M, bf16, batch "
          f"{trainer.batch_size} at {IMAGE}², {len(trainer.train_ds)} slices")
    check(trainer.batch_size == VAE_BATCH, f"VAE batch {trainer.batch_size}")
    start = [p.detach().clone() for p in trainer.vae_state.params]
    dstart = [p.detach().clone() for p in trainer.disc_state.params]
    log = []
    for name in ("ae_step", "d_step"):
        inner = getattr(trainer, name)

        def timed(*args, _inner=inner, _name=name, **kw):
            before = fa.LAUNCHES
            t0 = time.perf_counter()
            out = _inner(*args, **kw)
            torch.cuda.synchronize()
            log.append((_name, time.perf_counter() - t0,
                        fa.LAUNCHES - before, out))
            return out

        setattr(trainer, name, timed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0  # count only the main path from here
    t0 = time.perf_counter()
    step = trainer.fit(max_steps=VAE_TRAIN_STEPS, log_every=1)
    fit_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {"vae_train": fa.LAUNCHES}
    ae = [(w, n, out[1]) for name, w, n, out in log if name == "ae_step"]
    disc = [(w, n, out) for name, w, n, out in log if name == "d_step"]
    for i, ((wa, na, m), (wd, nd, dm)) in enumerate(zip(ae, disc)):
        vals = {k: float(v) for k, v in {**m, **dm}.items()}
        print(f"[latent] VAE step {i + 1}: AE {wa * 1e3:.2f} ms + disc "
              f"{wd * 1e3:.2f} ms, {na + nd} attention launches, "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(vals.items())))
        check(all(math.isfinite(v) for v in vals.values()),
              f"VAE step {i + 1}: non-finite metric {vals}")
        check(vals["d_weight"] > 0, f"VAE step {i + 1}: d_weight {vals}")
        check(na + nd == VAE_STEP_CALLS,
              f"VAE step {i + 1}: {na + nd} attention launches")
    step_s = statistics.median(wa + wd for (wa, _, _), (wd, _, _)
                               in zip(ae[1:], disc[1:]))
    # a tensor may have a gradient of exactly zero at every step, and then
    # stays: the attention's key bias (q.(k + b) shifts a row's scores
    # alike, which the softmax removes) and the discriminator's out-conv
    # bias (while every logit lies in (-1, 1) the hinge loss's two terms
    # pull it equally both ways). AdamW's first moment says which; a
    # parameter outside the graph would have raised in autograd.grad
    moved, zero_grad, unmoved = {}, {}, {}
    for net, state, first in (("VAE", trainer.vae_state, start),
                              ("discriminator", trainer.disc_state, dstart)):
        zero_grad[net] = [n for n, mu in zip(state.names, state.tx.mu)
                          if not mu.any()]
        unmoved[net] = [n for n, a, p in zip(state.names, first, state.params)
                        if torch.equal(a, p) and n not in zero_grad[net]]
        moved[net] = sum(not torch.equal(a, p)
                         for a, p in zip(first, state.params))
    print(f"[latent] VAE fit: {step} steps in {fit_wall:.2f} s, step "
          f"{step_s * 1e3:.2f} ms (median of steps 2-{step}, AE + disc), "
          f"{VAE_BATCH / step_s:.3f} slices/s, peak {peak:.3f} GiB; "
          f"parameter tensors moved: VAE {moved['VAE']}/{len(start)}, "
          f"discriminator {moved['discriminator']}/{len(dstart)}; gradient "
          f"exactly zero at every step: {zero_grad}; checkpoints "
          f"{trainer.ckpt.all_steps()} [{smi}]")
    check(step == VAE_TRAIN_STEPS and trainer.ckpt.latest_step() == step,
          f"VAE fit ended at {step}, checkpoints {trainer.ckpt.all_steps()}")
    check(not any(unmoved.values()), f"parameters with a gradient that did "
          f"not move: {unmoved}")
    before = fa.LAUNCHES
    t0 = time.perf_counter()
    rec = trainer.reconstruction_metrics(max_batches=1)
    torch.cuda.synchronize()
    launches["vae_reconstruct"] = fa.LAUNCHES - before
    print(f"[latent] reconstruction_metrics (1 batch of {VAE_BATCH}): {rec} "
          f"in {time.perf_counter() - t0:.2f} s, "
          f"{launches['vae_reconstruct']} attention launches")
    check(all(math.isfinite(v) for v in rec.values())
          and launches["vae_reconstruct"] == 2, f"reconstruction {rec}")
    return launches


def _vae_cli(vae_cfg, workdir: Path) -> None:
    """``python -m dsdiff_torch.cli.train_vae --max_steps 2``, no
    ``--device``: the entry point trains on the card by default."""
    # configs/autoencoder_kl.yaml as a user edits it: the top-level keys
    # the phase changes replaced (strings, integers and lists, written as
    # JSON, which YAML reads as written), the file otherwise as it is
    source = CONFIGS / "autoencoder_kl.yaml"
    want = dict(vae_cfg.to_dict(), result_path=str(workdir / "cli"))
    file_cfg = load_run_config(source)
    changed = {k: v for k, v in want.items() if file_cfg.get(k) != v}
    lines = [line for line in source.read_text().splitlines()
             if line.split(":", 1)[0] not in changed]
    cfg_path = workdir / "autoencoder_kl_smoke.yaml"
    cfg_path.write_text("\n".join(
        lines + [f"{k}: {json.dumps(v)}" for k, v in changed.items()]) + "\n")
    check(load_run_config(cfg_path) == want,
          "the edited autoencoder_kl.yaml does not read back as the phase's "
          "config")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "dsdiff_torch.cli.train_vae", "--config_file",
         str(cfg_path), "--max_steps", "2"], cwd=Path(__file__).resolve().parent,
        capture_output=True, text=True, timeout=600)
    run = workdir / "cli" / f"{vae_cfg['Task_name']}_{vae_cfg['Task_id']}_vae"
    saved = sorted(p.name for p in (run / "checkpoint").iterdir()) \
        if (run / "checkpoint").exists() else []
    print(f"[latent] python -m dsdiff_torch.cli.train_vae --max_steps 2: exit "
          f"{out.returncode} in {time.perf_counter() - t0:.1f} s, "
          f"'{out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ''}'"
          f", checkpoints {saved}")
    check(out.returncode == 0, f"train_vae CLI failed: {out.stderr[-2000:]}")
    check(saved == ["2"], f"train_vae CLI checkpoints {saved}")


def _latent_trainer(latent_cfg, workdir: Path, smi: str) -> dict:
    """The latent ``Trainer`` with the VAE phase's checkpoint as
    ``vae_checkpoint``: LATENT_TRAIN_STEPS steps through ``fit`` at batch 8
    (each batch encoded: LATENT_STEP_CALLS launches), then its validation (a
    DDIM-20 batch of 8: the conditions encoded, the sample decoded,
    LATENT_REQUEST_CALLS launches) and save; a second trainer that restores
    that checkpoint bit for bit then serves one DDIM-20 request of batch
    SERVE_BATCH through ``sample_images`` (LATENT_REQUEST_CALLS launches,
    decoded to 256²) and ``progressive_denoise`` (as many). Returns the
    launches."""
    torch.backends.cudnn.allow_tf32 = True
    run = workdir / "latent"
    trainer = Trainer(latent_cfg, run, device="cuda")
    fs = trainer.first_stage
    vae_state = torch.load(workdir / "vae" / "checkpoint"
                           / str(VAE_TRAIN_STEPS) / "state.pt",
                           map_location="cpu", weights_only=True)["params"]
    # held in the compute dtype: the checkpoint's f32 weights, rounded
    restored = all(torch.equal(p.cpu(), vae_state[n].to(p.dtype))
                   for n, p in fs.vae.named_parameters())
    print(f"[latent] Trainer: latent UNet {trainer.n_params / 1e6:.2f} M "
          f"params, in {trainer.in_ch} / out {trainer.base_out} channels on "
          f"{IMAGE // fs.downsample}² latents, bf16, remat; first stage from "
          f"the VAE run's checkpoint/{VAE_TRAIN_STEPS} (its weights, in the "
          f"compute dtype: {restored}), scale_factor {fs.scale_factor}")
    check(trainer.in_ch == 4 * (1 + LATENT_N_COND) and trainer.base_out == 4,
          "latent channels")
    check(restored, "the first stage is not the VAE checkpoint's")
    meter = _Meter(trainer)
    encodes: list = []
    fs.encode_batch = _Meter._wrap(fs.encode_batch, encodes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0  # count only the main path from here
    step = trainer.fit(max_steps=LATENT_TRAIN_STEPS, log_every=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    fit_launches = fa.LAUNCHES
    rows = [json.loads(line) for line in (run / "logs" / "progress.jsonl")
            .read_text().splitlines()]
    losses = [r["train_loss"] for r in rows if "train_loss" in r]
    print(f"[latent] fit: {step} steps at batch {trainer.train_loader.batch_size}"
          f": the batch's encode (conditions and target, "
          f"{(LATENT_N_COND + 1) * trainer.train_loader.batch_size} VAE "
          f"encoder passes at {IMAGE}²) " + ", ".join(
              f"{w * 1e3:.2f} ms" for w, _ in encodes)
          + "; the UNet train step " + ", ".join(
              f"{w * 1e3:.2f} ms" for w, _ in meter.steps)
          + f"; losses {losses}, peak {peak:.3f} GiB [{smi}]")
    check(all(n == LATENT_N_COND + 1 for _, n in encodes),
          f"latent encode launches {encodes}")
    check(step == LATENT_TRAIN_STEPS and len(losses) == step
          and all(math.isfinite(v) for v in losses), f"latent fit {rows}")
    check(all(n == LATENT_CALLS_PER_FORWARD for _, n in meter.steps),
          f"latent train step launches {meter.steps}")
    train_launches = sum(n for _, n in encodes + meter.steps)
    val_launches = fit_launches - train_launches
    launches = {"latent_fit": train_launches, "latent_validate": val_launches}
    check(train_launches == LATENT_TRAIN_STEPS * LATENT_STEP_CALLS,
          f"latent fit: {train_launches} attention launches in train steps")
    saved = json.loads((run / "checkpoint" / str(step) / "metrics.json")
                       .read_text())
    print(f"[latent] validate: {len(meter.samples)} DDIM-{DDIM_STEPS} batch "
          f"of {latent_cfg.get('val_batch_size')} (its sampler "
          + ", ".join(f"{w:.4f} s" for w, _ in meter.samples)
          + f"), {val_launches} attention launches; saved step {step} with "
          f"{saved} in " + ", ".join(f"{w:.2f} s" for w, _ in meter.saves)
          + f" [{smi}]")
    check(len(meter.samples) == 1 and val_launches == LATENT_REQUEST_CALLS,
          f"latent validation: {meter.samples}, {val_launches} launches, not "
          f"{LATENT_REQUEST_CALLS}")
    check(trainer.ckpt.all_steps() == [step] and set(saved) == {
        "val_ssim", "val_mae"} and all(math.isfinite(v)
                                       for v in saved.values()),
          f"latent checkpoints {trainer.ckpt.all_steps()}, metrics {saved}")

    # a second trainer on the run: restore, then serve from it
    resumed = Trainer(latent_cfg, run, device="cuda")
    t0 = time.perf_counter()
    resumed.state, resumed.sampler_state = resumed.ckpt.restore(
        resumed.state, resumed.sampler_state)
    restore_s = time.perf_counter() - t0
    diff = _state_equal(trainer, resumed)
    print(f"[latent] restored step {resumed.state.step} in {restore_s:.2f} s "
          f"bit for bit: {not diff}")
    check(not diff, f"the restored latent state differs at {diff[:4]}")
    del trainer, meter
    trainer = resumed

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    cond = torch.rand(SERVE_BATCH, IMAGE, IMAGE, LATENT_N_COND, generator=gen,
                      device="cuda") * 2 - 1
    for what in ("request", "progressive_denoise"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = fa.LAUNCHES
        t0 = time.perf_counter()
        if what == "request":
            out = trainer.sample_images(cond, gen)
            frames = None
        else:
            out, frames = trainer.progressive_denoise(cond, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = fa.LAUNCHES - before
        launches[f"latent_{what}"] = launched
        print(f"[latent] {what}: DDIM-{DDIM_STEPS}, batch {SERVE_BATCH}, "
              f"{IMAGE}²: {wall:.4f} s, {SERVE_BATCH / wall:.3f} slices/s, "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
              f"{launched} attention launches, decoded {tuple(out.shape)} "
              f"in [{out.min().item():.4f}, {out.max().item():.4f}]"
              + ("" if frames is None else
                 f", {tuple(frames.shape)} latent x0 frames") + f" [{smi}]")
        # the decoder's output is not clipped (nor is the JAX package's);
        # DDIM clips each latent x0 to [-1, 1]
        _check_sample(out, SERVE_BATCH, IMAGE, False, f"latent {what}")
        check(launched == LATENT_REQUEST_CALLS, f"latent {what}: {launched} "
              f"attention launches, not {LATENT_REQUEST_CALLS}")
        if frames is not None:
            check(frames.shape == (DDIM_STEPS, SERVE_BATCH, IMAGE // 8,
                                   IMAGE // 8, 4), f"frames {frames.shape}")
            check(frames.abs().max().item() <= 1.0,
                  "latent x0 frames outside [-1, 1]")
    launches["latent_predict"] = _latent_predict(trainer, latent_cfg, workdir,
                                                 run, smi)
    return launches


def _latent_predict(trainer, latent_cfg, workdir: Path, run: Path,
                    smi: str) -> int:
    """The latent ``Trainer.predict`` and ``python -m dsdiff_torch.cli.sample``
    (no ``--device``) on the run's checkpoint, each on a split of one test
    case: one NIfTI volume each. Returns predict's attention launches."""
    root = Path(latent_cfg.get("h5_2d_img_dir"))
    split = f"images_ts_{IMAGE}"
    case = sorted(p.name for p in (root / split).iterdir())[0]
    (root / "images_ts_one").mkdir()
    (root / "images_ts_one" / case).symlink_to(root / split / case)
    vbs = int(latent_cfg.get("val_batch_size"))
    before = fa.LAUNCHES
    t0 = time.perf_counter()
    out_dir, _ = trainer.predict(out_dir=workdir / "latent_pred",
                                 split="images_ts_one")
    wall = time.perf_counter() - t0
    launched = fa.LAUNCHES - before
    vols = sorted(out_dir.glob("*_pred.nii.gz"))
    print(f"[latent] predict: one case of {FIT_SLICES} slices in batches of "
          f"{vbs}, {len(vols)} volume in {wall:.2f} s, {launched} attention "
          f"launches [{smi}]")
    check(len(vols) == 1, f"latent predict wrote {len(vols)} volumes")
    vol = read_nifti(vols[0]).data
    check(vol.shape == (IMAGE, IMAGE, FIT_SLICES) and np.isfinite(vol).all(),
          f"latent predicted volume {vol.shape}")
    check(launched == -(-FIT_SLICES // vbs) * LATENT_REQUEST_CALLS,
          f"latent predict: {launched} attention launches")

    # the CLI on a store of the train split and that one test case; the
    # merged config as JSON, which YAML reads as written (config_opt named
    # the model file it merged already)
    one = workdir / "one"
    (one / split).mkdir(parents=True)
    (one / f"images_tr_{IMAGE}").symlink_to(root / f"images_tr_{IMAGE}")
    (one / split / case).symlink_to(root / split / case)
    cfg_path = workdir / "latent_smoke.yaml"
    cli_cfg = dict(latent_cfg.to_dict(), h5_2d_img_dir=str(one),
                   filepath_img="")
    cli_cfg.pop("config_opt", None)
    cfg_path.write_text(json.dumps(cli_cfg))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "dsdiff_torch.cli.sample", "--config_file",
         str(cfg_path), "--workdir", str(run), "--out_dir",
         str(workdir / "latent_cli_pred")],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    vols = sorted((workdir / "latent_cli_pred").glob("*_pred.nii.gz"))
    print(f"[latent] python -m dsdiff_torch.cli.sample (net_mode latent): "
          f"exit {out.returncode} in {wall:.1f} s, {len(vols)} volume, "
          f"'{out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ''}'"
          f" [{smi}]")
    check(out.returncode == 0, f"latent sample CLI failed: {out.stderr[-2000:]}")
    check(len(vols) == 1, f"latent sample CLI wrote {len(vols)} volumes")
    return launched


def phase_latent(smi: str):
    """The latent pipeline at full width: kernel rows at its shapes,
    kernel vs plain parity of the VAE and the latent UNet, the VAE's GAN
    training (in process and through its CLI) on a synthetic npy store,
    then the latent trainer on that VAE's checkpoint. Returns (kernel rows,
    attention launches by path)."""
    t_phase = time.perf_counter()
    rows = _latent_kernel_rows(smi)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_latent_"))
    try:
        root = tmp / "data"
        synthetic.make_structured_dataset(root, n_cases=FIT_CASES,
                                          n_slices=FIT_SLICES, hw=IMAGE,
                                          seed=SEED, store="npy")
        vae_cfg, latent_cfg = latent_configs(root, tmp)
        print("[latent] cuts: " + ", ".join(
            f"{k} {a} -> {b}" for k, (a, b) in {**VAE_CUTS,
                                                **LATENT_CUTS}.items())
              + f"; {VAE_TRAIN_STEPS} VAE steps and {LATENT_TRAIN_STEPS} "
              f"latent steps; train_keys are the synthetic store's A, B, C "
              f"-> GT; vae_checkpoint is the VAE phase's")
        _latent_parity(latent_cfg)
        launches = _vae_train(vae_cfg, tmp, smi)
        _vae_cli(vae_cfg, tmp)
        launches.update(_latent_trainer(latent_cfg, tmp, smi))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[latent] done in {time.perf_counter() - t_phase:.1f} s")
    return rows, launches



# ------------------------------------------------ int8, cache, dist (PR 9)
def shared_store() -> Path:
    """One synthetic npy store (FIT_CASES x FIT_SLICES at 256²) for the
    int8, cache and dist phases, made at first use; ``main`` removes it."""
    if "root" not in _STORE:
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_store_"))
        synthetic.make_structured_dataset(tmp / "data", n_cases=FIT_CASES,
                                          n_slices=FIT_SLICES, hw=IMAGE,
                                          seed=SEED, store="npy")
        _STORE.update(tmp=tmp, root=tmp / "data")
    return _STORE["root"]


def _eligible_calls(model, n_in: int) -> list:
    """(name, input shape, channels-last, weight shape, stride, padding) of
    each int8-eligible conv call in one forward of ``model`` at batch
    SERVE_BATCH, 256², convs as they are."""
    calls = []

    def record(name):
        def hook(mod, args):
            x = args[0]
            calls.append((name, tuple(x.shape),
                          x.is_contiguous(memory_format=torch.channels_last),
                          tuple(mod.weight.shape), tuple(mod.stride),
                          tuple(mod.padding)))
        return hook

    hooks = [m.register_forward_pre_hook(record(n))
             for n, m in model.named_modules()
             if hasattr(m, "int8") and quant.eligible(m)]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    try:
        with torch.inference_mode(), quant.suspended(model):
            model(torch.randn(SERVE_BATCH, IMAGE, IMAGE, n_in, generator=gen,
                              device="cuda"),
                  torch.full((SERVE_BATCH,), 500.0, device="cuda"))
    finally:
        for h in hooks:
            h.remove()
    return calls


def _conv_ops(shape, w, stride) -> int:
    B, _, H, W = shape
    O, I, kh, kw = w
    return 2 * B * (H // stride[0]) * (W // stride[1]) * O * I * kh * kw


def _int8_exact(calls) -> int:
    """int8_sums against an f64 conv of the same int8 operands at every
    distinct eligible shape: equal, exactly. Returns the shapes held."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    distinct = sorted({c[1:2] + c[3:] for c in calls})
    for shape, w, stride, pad in distinct:
        x = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int8)
        wi = torch.randint(-127, 128, w, generator=gen, device="cuda",
                           dtype=torch.int8)
        got = quant.int8_sums(x, quant.pack_weight(wi), w[2:], w[0], stride,
                              pad)
        want = F.conv2d(x.double(), wi.double(), stride=stride, padding=pad)
        check(torch.equal(got.double(), want.permute(0, 2, 3, 1)),
              f"int8 sums differ from the f64 conv at {shape}, {w}, {stride}")
        del x, wi, got, want
    return len(distinct)


def _int8_rows(calls, smi: str) -> list:
    """The int8 conv (quantise, im2col, ``torch._int_mm``, dequantise)
    against the bf16 cuDNN conv, event-timed on rotated inputs, at the
    INT8_HEAVIEST shapes with the most operations in a forward."""
    counts = collections.Counter(c[1:] for c in calls)
    heaviest = sorted(counts, key=lambda k: -_conv_ops(k[0], k[2], k[3])
                      * counts[k])[:INT8_HEAVIEST]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    rows = []
    for key in heaviest:
        shape, channels_last, w, stride, pad = key
        x = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        if channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        weight = torch.randn(w, generator=gen, device="cuda") * 0.05
        bias = torch.randn(w[0], generator=gen, device="cuda") * 0.1
        w_i8, w_scale = quant.quantize_weight(weight)
        packed = quant.pack_weight(w_i8)
        wb, bb = weight.bfloat16(), bias.bfloat16()
        inputs = rotated((x,), x.numel() * 2)
        int8_ms = time_ms_cycling(
            lambda a: quant.int8_conv(a, w_i8, w_scale, bias, stride, pad,
                                      packed=packed), inputs, 40)
        bf16_ms = time_ms_cycling(
            lambda a: F.conv2d(a, wb, bb, stride, pad), inputs, 40)
        B, C, H, W = shape
        out_elems = B * w[0] * (H // stride[0]) * (W // stride[1])
        ops = _conv_ops(shape, w, stride)
        t_bytes = (x.numel() * 2 + w_i8.numel() + out_elems * 2) / PEAK_BYTES_PER_S
        t_ops = ops / INT8_PEAK_OPS
        rows.append(dict(
            shape=list(shape), weight=list(w), stride=list(stride),
            per_forward=counts[key], int8_ms=int8_ms, bf16_cudnn_ms=bf16_ms,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="operations" if t_ops > t_bytes else "bytes",
            gops=ops / 1e9))
        print(f"[int8] conv {w[1]}->{w[0]} {w[2]}x{w[3]} stride {stride[0]} "
              f"on {list(shape)}: {counts[key]} a forward; int8 {int8_ms:.5f} "
              f"ms, bf16 cuDNN {bf16_ms:.5f} ms, bound {rows[-1]['bound_ms']:.5f}"
              f" ms ({rows[-1]['bound_by']}) [{smi}]")
        del x, inputs
    return rows


def _timed_request(trainer, cond, x_T):
    """(sample, wall s, peak GiB, attention launches, int8 convs) of one
    request through ``trainer.sample_fn``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_before, q_before = fa.LAUNCHES, quant.LAUNCHES
    t0 = time.perf_counter()
    out = trainer.sample_fn(cond, None, x_T)
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2**30,
            fa.LAUNCHES - fa_before, quant.LAUNCHES - q_before)


def phase_int8(smi: str):
    """The flagship at full width served with int8 convolutions: the sums
    exact at every eligible shape, the four heaviest timed against cuDNN,
    DDIM-20 requests with ``set_sampler(int8=True)`` and ``'static'``
    (calibrated on the synthetic store's val split), the bf16 request
    restored bit for bit by ``int8=False``, and an int8 request on the
    cached ``ds_diff_split`` sampler. Returns (conv rows, attention
    launches by path, int8 conv launches)."""
    torch.backends.cudnn.allow_tf32 = True
    t_phase = time.perf_counter()
    trainer = Trainer(_fit_config(shared_store()), device="cuda")
    random_params(trainer.model, SEED)
    trainer.reset_state()
    trainer._refresh_sample_model()
    calls = _eligible_calls(trainer.sample_model, trainer.in_ch)
    per_forward = len(calls)
    check(per_forward == len({c[0] for c in calls}) > 0,
          "an eligible conv ran twice in a forward")
    held = _int8_exact(calls)
    print(f"[int8] {per_forward} eligible convs a forward (of "
          f"{sum(hasattr(m, 'int8') for m in trainer.sample_model.modules())}"
          f"), {held} distinct shapes: int32 sums equal the f64 conv's, "
          f"exactly")
    rows = _int8_rows(calls, smi)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    cond = torch.randn(SERVE_BATCH, IMAGE, IMAGE, trainer.n_cond,
                       generator=gen, device="cuda")
    x_T = torch.randn(SERVE_BATCH, IMAGE, IMAGE, 1, generator=gen,
                      device="cuda")
    per_request = CALLS_PER_FORWARD * DDIM_STEPS
    bf16, wall, peak, n_attn, _ = _timed_request(trainer, cond, x_T)
    print(f"[int8] bf16 request: {wall:.4f} s, {SERVE_BATCH / wall:.3f} "
          f"slices/s, peak {peak:.3f} GiB [{smi}]")
    fa.LAUNCHES = quant.LAUNCHES = 0  # count only the main path from here
    launches = {}
    for mode in (True, "static"):
        t0 = time.perf_counter()
        trainer.set_sampler(int8=mode)
        setup = time.perf_counter() - t0
        out, wall, peak, n_attn, n_q = _timed_request(trainer, cond, x_T)
        name = "int8_dynamic" if mode is True else "int8_static"
        launches[name] = n_attn
        diff = (out - bf16).abs().max().item()
        print(f"[int8] {name} request: {wall:.4f} s, {SERVE_BATCH / wall:.3f} "
              f"slices/s, peak {peak:.3f} GiB, {n_q} int8 convs "
              f"({n_q / DDIM_STEPS:g} a forward), {n_attn} attention launches"
              f"; max |int8 - bf16| {diff:.4f}; set_sampler {setup:.2f} s"
              + (f" (calibration: {len(trainer._act_scales)} scales)"
                 if mode == "static" else "") + f" [{smi}]")
        _check_sample(out, SERVE_BATCH, IMAGE, True, name)
        check(n_q == per_forward * DDIM_STEPS,
              f"{name}: {n_q} int8 convs, not {per_forward} x {DDIM_STEPS}")
        check(n_attn == per_request, f"{name}: {n_attn} attention launches")
        check(diff > 0, f"{name}: the request equals the bf16 one")
    trainer.set_sampler(int8=False)
    again, wall, _, n_attn, n_q = _timed_request(trainer, cond, x_T)
    launches["int8_restored"] = n_attn
    print(f"[int8] set_sampler(int8=False): {wall:.4f} s, {n_q} int8 convs, "
          f"the bf16 request bit for bit: {torch.equal(again, bf16)}")
    check(torch.equal(again, bf16) and n_q == 0,
          "int8=False does not restore the bf16 request")
    q_full = quant.LAUNCHES
    del trainer, bf16, again, out

    cached = _serving_trainer(SPLIT_CONFIG)
    cached.set_sampler(int8=True)
    counted = []
    hooks = [m.register_forward_pre_hook(lambda *a: counted.append(1))
             for m in cached.sample_model.modules()
             if hasattr(m, "int8") and quant.eligible(m)]
    out, wall, peak, n_attn, n_q = _timed_request(cached, cond, x_T)
    for h in hooks:
        h.remove()
    launches["int8_cached"] = n_attn
    print(f"[int8] cached (ds_diff_split) int8 request: {wall:.4f} s, "
          f"{SERVE_BATCH / wall:.3f} slices/s, peak {peak:.3f} GiB, {n_q} "
          f"int8 convs of {len(counted)} eligible calls, {n_attn} attention "
          f"launches [{smi}]")
    _check_sample(out, SERVE_BATCH, IMAGE, True, "int8 cached")
    check(n_q == len(counted) > 0, f"cached: {n_q} int8 convs of "
          f"{len(counted)} eligible calls")
    check(n_attn == CACHED_REQUEST_CALLS, f"cached: {n_attn} attention launches")
    print(f"[int8] done in {time.perf_counter() - t_phase:.1f} s")
    return rows, launches, q_full + n_q


def _h2d_copies(trace: Path, batch_bytes: int):
    """(every host-to-device copy, those of at least a batch's bytes) in a
    ``torch.profiler`` chrome trace: (count, bytes) each."""
    events = json.loads(trace.read_text()).get("traceEvents", [])
    sizes = [int((e.get("args") or {}).get("bytes", 0)) for e in events
             if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    big = [s for s in sizes if s >= batch_bytes]
    return (len(sizes), sum(sizes)), (len(big), sum(big))


def phase_cache(smi: str):
    """``fit`` at the config's batch 32 with ``device_data_cache: true``
    against the host loader's ``fit`` at the same batch; the steady state's
    host-to-device copies from ``torch.profiler``; the cache's batch
    against ``DeviceCache.plain_batch`` on the same draws."""
    torch.backends.cudnn.allow_tf32 = True
    t_phase = time.perf_counter()
    root = shared_store()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cache_"))
    try:
        host = Trainer(_fit_config(root), tmp / "host", device="cuda")
        meter = _Meter(host)
        host.fit(num_epochs=3, max_steps=1 + CACHE_STEPS, log_every=1,
                 val_on_done=False)
        host_ms = statistics.median(w for w, _ in meter.steps[1:]) * 1e3
        del host, meter
        cfg = dict(_fit_config(root), device_data_cache=True)
        trainer = Trainer(cfg, tmp / "cache", device="cuda")
        t0 = time.perf_counter()
        trainer.fit(max_steps=1, log_every=1, val_on_done=False)
        first_s = time.perf_counter() - t0
        cache = trainer.device_cache
        copies = []
        to_device = trainer._to_device
        trainer._to_device = lambda a: copies.append(1) or to_device(a)
        meter = _Meter(trainer)
        trainer.fit(num_epochs=3, max_steps=1 + CACHE_STEPS, log_every=1,
                    val_on_done=False)
        walls = [w for w, _ in meter.steps]
        cache_ms = statistics.median(walls) * 1e3
        meter = _Meter(trainer)
        fa.LAUNCHES = 0  # count only the main path from here
        trace = tmp / "cache_trace.json"
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            step = trainer.fit(num_epochs=3, max_steps=1 + 2 * CACHE_STEPS,
                               log_every=1, val_on_done=False)
        prof.export_chrome_trace(str(trace))
        launches = fa.LAUNCHES
        batch_bytes = FIT_BATCH * IMAGE * IMAGE * 2  # a batch's bf16 image
        (n_all, b_all), (n_big, b_big) = _h2d_copies(trace, batch_bytes)
        profiled = [w for w, _ in meter.steps]
        print(f"[cache] split on the card: {cache.n} slices "
              f"{list(cache.images.shape[1:])} + target, {cache.images.dtype}"
              f", {(cache.images.numel() + cache.targets.numel()) * 2 / 2**20:.1f}"
              f" MiB; first fit call (upload + 1 step) {first_s:.2f} s")
        print(f"[cache] fit steps 2-{1 + CACHE_STEPS} at batch {FIT_BATCH}: "
              + ", ".join(f"{w * 1e3:.2f} ms" for w in walls)
              + f" (median {cache_ms:.2f} ms); the host loader's median of "
              f"steps 2-{1 + CACHE_STEPS} {host_ms:.2f} ms [{smi}]")
        print(f"[cache] the same steps again under torch.profiler ("
              + ", ".join(f"{w * 1e3:.2f} ms" for w in profiled)
              + f"): host-to-device copies {n_all} ({b_all} bytes), {n_big} "
              f"of a batch or more; batch copies through the loader path: "
              f"{len(copies)}")
        check(step == 1 + 2 * CACHE_STEPS,
              f"the cached fit ended at step {step}")
        check(n_big == 0 and not copies,
              f"{n_big} batch-sized host-to-device copies in the cached fit")
        check(all(n == CALLS_PER_FORWARD for _, n in meter.steps)
              and launches == CACHE_STEPS * CALLS_PER_FORWARD,
              f"cached fit attention launches {meter.steps}")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
        draws = cache.draw(FIT_BATCH, gen, float(cfg["augmentation_prob"]))
        got = cache.batch(draws)
        plain = cache.plain_batch(draws)
        err = max((got[k] - plain[k]).abs().max().item()
                  for k in ("image", "target"))
        print(f"[cache] a batch of {FIT_BATCH}: {int(draws.do_rot.sum())} "
              f"rotated, {int(draws.flip_h.sum())} / {int(draws.flip_w.sum())}"
              f" flipped; max |batch - plain gather + augment| {err:.3e} "
              f"(tol {CACHE_TOL:.0e})")
        check(err <= CACHE_TOL, f"the cache's batch differs by {err}")
        print(f"[cache] done in {time.perf_counter() - t_phase:.1f} s")
        return {"cache_fit": launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_dist(smi: str):
    """One NCCL rank (world 1, a file store): the flagship ``fit`` through
    the mesh path (data 1, fsdp 1) for DIST_STEPS steps at batch 32 against
    the mesh-less ``fit`` from the same seed, cuDNN deterministic in both;
    the parameters bit for bit (else within the spread of two mesh-less
    runs)."""
    import torch.distributed as tdist

    from dsdiff_torch.parallel import dist as pdist
    from dsdiff_torch.parallel import mesh as pmesh

    torch.backends.cudnn.allow_tf32 = True
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    t_phase = time.perf_counter()
    cfg = _fit_config(shared_store())
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))

    def run(name, mesh=None):
        trainer = Trainer(cfg, tmp / name, device="cuda", mesh=mesh)
        meter = _Meter(trainer)
        step = trainer.fit(num_epochs=3, max_steps=DIST_STEPS, log_every=1,
                           val_on_done=False)
        check(step == DIST_STEPS, f"{name} fit ended at step {step}")
        params = [p.detach().clone() for p in trainer.state.params]
        return params, [w for w, _ in meter.steps], sum(
            n for _, n in meter.steps)

    try:
        plain, plain_walls, _ = run("plain")
        pdist.initialize(f"file://{tmp / 'store'}", 1, 0, backend="nccl")
        check(tdist.get_backend() == "nccl" and pdist.process_count() == 1,
              "not one NCCL rank")
        fa.LAUNCHES = 0  # count only the main path from here
        meshed, mesh_walls, launches = run("mesh", pmesh.make_mesh(1, 1))
        diff = max((a - b).abs().max().item() for a, b in zip(meshed, plain))
        same = all(torch.equal(a, b) for a, b in zip(meshed, plain))
        floor = None
        if not same:  # cuDNN or a kernel not deterministic: its own spread
            again, _, _ = run("plain_again")
            floor = max((a - b).abs().max().item()
                        for a, b in zip(again, plain))
        print(f"[dist] one NCCL rank, mesh data 1 x fsdp 1, fit {DIST_STEPS} "
              f"steps at batch {FIT_BATCH}: " + ", ".join(
                  f"{w * 1e3:.2f} ms" for w in mesh_walls)
              + "; mesh-less: " + ", ".join(f"{w * 1e3:.2f} ms"
                                            for w in plain_walls)
              + f"; median of steps 2-{DIST_STEPS} "
              f"{statistics.median(mesh_walls[1:]) * 1e3:.2f} vs "
              f"{statistics.median(plain_walls[1:]) * 1e3:.2f} ms; parameters "
              + ("bit for bit" if same else
                 f"max |mesh - mesh-less| {diff:.3e} (two mesh-less runs: "
                 f"{floor:.3e})") + f" [{smi}]")
        check(same or diff <= floor,
              f"the mesh path's parameters differ by {diff} (floor {floor})")
        check(launches == DIST_STEPS * CALLS_PER_FORWARD,
              f"{launches} attention launches in the mesh fit")
        print(f"[dist] done in {time.perf_counter() - t_phase:.1f} s")
        return {"dist_fit": launches}
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(tmp, ignore_errors=True)


def phase_transformer_kernels(card: str) -> list:
    """The attention kernel at the transformer conditioning path's shapes,
    both dtypes, timed: the crossattn fusion's self [4, 64, 8, 36] and
    cross (M = 256) attention as its Dense outputs give them (a 72-byte head
    stride: the bf16 route's threads load the tiles, no TMA map describes
    them), the patched request's tiles (36 of 128², qkv thirds) and the
    guidance classifier's [4, 1024, 4, 128]. Returns the rows, each with
    its ``path``."""
    disable_tf32()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for N, H, D, M, calls in FUSION_ATTENTION:
            row = _attention_row(gen, SERVE_BATCH, N, H, D, dtype, calls,
                                 card, M=M, layout="dense")
            rows.append(dict(row, path="crossattn fusion"))
            if dtype == torch.bfloat16:
                check(row["load"] != "tma", f"fusion {row['shape']}: a TMA "
                      f"map cannot take a {2 * D}-byte head stride")
        for N, H, D, calls in PATCH_ATTENTION:
            row = _attention_row(gen, SERVE_BATCH * PATCH_TILES, N, H, D,
                                 dtype, calls, card)
            rows.append(dict(row, path="patched tiles"))
        for N, H, D, calls in CLASSIFIER_ATTENTION:
            row = _attention_row(gen, SERVE_BATCH, N, H, D, dtype, calls,
                                 card)
            rows.append(dict(row, path="guidance classifier"))
    return rows


def transformer_config(overrides: dict) -> dict:
    """The flagship run config with ``overrides`` in its
    ``unet_config.params``, as a user sets them."""
    params = dict(FLAGSHIP_CONFIG["unet_config"]["params"], **overrides)
    return Config.wrap(dict(FLAGSHIP_CONFIG, unet_config={"params": params}))


def phase_transformer(smi: str) -> dict:
    """The flagship with each TRANSFORMER_RUNS override, through
    ``Trainer``: full-width forward parity with the kernel against plain
    attention (f32 and bf16), one DDIM-20 request at batch 4, three bf16
    train steps at batch 8, each with its attention launches. Returns the
    launches by path."""
    launches = {}
    for name, overrides, calls in TRANSFORMER_RUNS:
        t0 = time.perf_counter()
        cfg = transformer_config(overrides)
        print(f"[transformer] {name}: unet_config.params + {overrides}, "
              f"{calls} attention launches a forward")
        _family_parity(cfg, calls, "transformer")
        trainer = _serving_trainer(cfg)
        print(f"[transformer] {name}: {type(trainer.model).__name__} "
              f"{trainer.n_params / 1e6:.2f} M params, bf16")
        launches[f"{name}_serve"] = _family_request(trainer, calls, smi,
                                                    "transformer")
        launches[f"{name}_train"] = _family_train(trainer, calls, smi,
                                                  "transformer")
        del trainer
        torch.cuda.empty_cache()
        print(f"[transformer] {name} done in "
              f"{time.perf_counter() - t0:.1f} s")
    return launches


def _timed(fn):
    """(fn(), host wall in s up to a synchronised device)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _hold_request(what: str, got, want) -> float:
    """A request with the kernel within the bf16 forward tolerance of the
    same request with plain attention; returns the error."""
    err = (got.float() - want.float()).abs().max().item()
    tol = MODEL_BF16_RTOL * max(1.0, want.float().abs().max().item())
    print(f"[{what}] kernel vs plain-attention request: max_abs_err "
          f"{err:.3e} (tol {tol:.3e})")
    check(err <= tol, f"{what}: request error {err} over {tol}")
    return err


def phase_patched(smi: str) -> dict:
    """One patched DDIM-20 request (batch 4, 256², ``split_input_params``
    PATCH) on the flagship through ``Trainer.sample_fn``: every model call
    one call over the 36 tiles, 34 kernel launches each; held to the same
    request with plain attention; its wall against the unpatched request's
    on the same trainer (each timed after one warm-up request)."""
    trainer = _serving_trainer(dict(FLAGSHIP_CONFIG,
                                    split_input_params=PATCH))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    cond = torch.randn(SERVE_BATCH, IMAGE, IMAGE, trainer.n_cond,
                       generator=gen, device="cuda")
    x_T = torch.randn(SERVE_BATCH, IMAGE, IMAGE, 1, generator=gen,
                      device="cuda")
    batches = []
    hook = trainer.sample_model.register_forward_hook(
        lambda m, args, out: batches.append(args[0].shape[0]))
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0  # count only the main path from here
    try:
        out, wall = _timed(lambda: trainer.sample_fn(cond, gen, x_T))
    finally:
        hook.remove()
    launched = fa.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2**30
    tiles = SERVE_BATCH * PATCH_TILES
    per_call = CALLS_PER_FORWARD
    print(f"[patched] DDIM-{DDIM_STEPS} request, batch {SERVE_BATCH}, "
          f"{IMAGE}², ks {PATCH['ks']} stride {PATCH['stride']}: {wall:.4f} "
          f"s (first), peak {peak:.3f} GiB, {len(batches)} model calls of "
          f"{sorted(set(batches))} tiles, {launched} attention launches "
          f"[{smi}]")
    _check_sample(out, SERVE_BATCH, IMAGE, True, "patched request")
    check(batches == [tiles] * DDIM_STEPS,
          f"patched: model calls over {batches}, not {DDIM_STEPS} of {tiles}")
    check(launched == per_call * DDIM_STEPS,
          f"patched: {launched} launches, not {per_call * DDIM_STEPS}")
    plain = _with_plain_attention(lambda: trainer.sample_fn(cond, gen, x_T))
    _hold_request("patched", out, plain)
    _, patched_wall = _timed(lambda: trainer.sample_fn(cond, gen, x_T))
    trainer.cfg["split_input_params"] = None
    trainer.set_sampler("ddim")
    trainer.sample_fn(cond, gen, x_T)  # warm-up at the whole-slice shapes
    whole, whole_wall = _timed(lambda: trainer.sample_fn(cond, gen, x_T))
    seam = (whole - out).abs().max().item()
    print(f"[patched] request wall {patched_wall:.4f} s "
          f"({SERVE_BATCH / patched_wall:.3f} slices/s) against the unpatched "
          f"request's {whole_wall:.4f} s ({SERVE_BATCH / whole_wall:.3f} "
          f"slices/s), {patched_wall / whole_wall:.3f}x; max |patched - "
          f"unpatched| {seam:.3e} [{smi}]")
    del trainer
    torch.cuda.empty_cache()
    return {"patched_serve": launched}


def _guided_setup(dtype):
    """The ddpm trainer (configs/train_config.yaml + ddpm.yaml; bf16, or
    f32 with ``bf16: false``) and an EncoderUNet in ``dtype``, both with
    the weights of SEED, and ``request(guided, plain)``: one DDIM-20
    request of batch 4 at 256² from the trainer's serving UNet through
    ``core.sampling.ddim_sample_loop``, its ``guidance_fn`` the classifier's
    gradient (scale GUIDE_SCALE) where ``guided``, with plain attention in
    both models where ``plain``. The inputs come from one seed, so every
    dtype serves the same request."""
    cfg = family_config("ddpm", "ddpm.yaml")
    trainer = _serving_trainer(dict(cfg, bf16=dtype == torch.bfloat16))
    trainer._refresh_sample_model()
    model, task = trainer.sample_model, trainer.task
    clf = EncoderUNet(in_channels=1, num_classes=GUIDE_CLASSES,
                      image_size=IMAGE, dtype=dtype)
    clf = random_params(clf.to("cuda"), SEED).eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    cond = torch.randn(SERVE_BATCH, IMAGE, IMAGE, trainer.n_cond,
                       generator=gen, device="cuda")
    x_T = torch.randn(SERVE_BATCH, IMAGE, IMAGE, 1, generator=gen,
                      device="cuda")
    y = torch.arange(SERVE_BATCH, device="cuda") % GUIDE_CLASSES

    def guide(x, t):
        return classifier_gradient(clf, x, t, y, GUIDE_SCALE)

    def request(guided=True, plain=False):
        def run():
            with torch.inference_mode():
                return sampling.ddim_sample_loop(
                    trainer.rsched,
                    lambda x, t: model(torch.cat([x, cond], dim=-1), t), x_T,
                    parameterization=task.parameterization,
                    learn_sigma=task.learn_sigma, clip_denoised=True,
                    guidance_fn=guide if guided else None)
        return _with_plain_attention(run) if plain else run()

    return clf, x_T, y, request


def phase_guided(smi: str) -> dict:
    """Classifier-guided DDIM-20 requests (batch 4, 256²): the ddpm
    trainer's serving UNet (configs/train_config.yaml + ddpm.yaml) with
    ``guidance_fn`` the gradient of an EncoderUNet (random weights) through
    the kernel's autograd.Function.

    bf16, the serving dtype: the classifier's forward launches (3 a call)
    and backward launches (0: the backward is the plain math's VJP)
    counted, the gradient non-zero, one request's wall and launches
    (20 x (16 + 3)); its gap to the same request with plain attention is
    printed beside the unguided request's gap, not held: an eps-param chain
    turns the kernel's one-ulp bf16 differences into gaps of the order of
    0.1 (x0 = (x - sqrt(1 - acp) eps) / sqrt(acp) magnifies eps ~1/sqrt(acp)
    at the chain's first steps), guided or not. f32 with TF32 off (the
    kernel's tf32x3 route): the same request held to plain attention within
    MODEL_RTOL of max(1, max |out|)."""
    clf, x_T, y, request = _guided_setup(torch.bfloat16)
    t_model = torch.full((SERVE_BATCH,), 999.0, device="cuda")
    x_in = x_T.clone().requires_grad_(True)
    before = fa.LAUNCHES
    logits = clf(x_in, t_model)
    fwd = fa.LAUNCHES - before
    logp = torch.log_softmax(logits, -1).gather(1, y[:, None]).sum()
    (grad,) = torch.autograd.grad(logp, x_in)
    torch.cuda.synchronize()
    bwd = fa.LAUNCHES - before - fwd
    gmax = grad.abs().max().item()
    print(f"[guided] EncoderUNet "
          f"{sum(p.numel() for p in clf.parameters()) / 1e6:.2f} M params, "
          f"bf16, pool adaptive: {fwd} kernel launches a forward, {bwd} a "
          f"backward, max |grad log p(y|x)| {gmax:.3e}")
    check(fwd == CLASSIFIER_CALLS and bwd == 0,
          f"guided: classifier launches {fwd} forward, {bwd} backward")
    check(math.isfinite(gmax) and gmax > 0, f"guided: gradient {gmax}")

    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0  # count only the main path from here
    out, wall = _timed(request)
    launched = fa.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = DDIM_STEPS * (DDPM_CALLS + CLASSIFIER_CALLS)
    print(f"[guided] DDIM-{DDIM_STEPS} request, batch {SERVE_BATCH}, "
          f"{IMAGE}², bf16, scale {GUIDE_SCALE}: {wall:.4f} s, "
          f"{SERVE_BATCH / wall:.3f} slices/s, peak {peak:.3f} GiB, "
          f"{launched} attention launches ({DDIM_STEPS} x ({DDPM_CALLS} UNet "
          f"+ {CLASSIFIER_CALLS} classifier)) [{smi}]")
    _check_sample(out, SERVE_BATCH, IMAGE, True, "guided request")
    check(launched == want, f"guided: {launched} launches, not {want}")
    unguided, unguided_wall = _timed(lambda: request(guided=False))
    gaps = [(a - b).abs().max().item() for a, b in (
        (out, request(plain=True)),
        (unguided, request(guided=False, plain=True)))]
    moved = (out - unguided).abs().max().item()
    print(f"[guided] bf16 kernel vs plain-attention request: max_abs_err "
          f"{gaps[0]:.3e} guided, {gaps[1]:.3e} unguided (not held, see the "
          f"phase's doc); unguided wall {unguided_wall:.4f} s; max |guided - "
          f"unguided| {moved:.3e}")
    check(moved > 0, "guided: the guidance did not move the sample")
    del clf, request
    torch.cuda.empty_cache()

    disable_tf32()
    _, _, _, request = _guided_setup(torch.float32)
    before = fa.LAUNCHES
    out32, wall32 = _timed(request)
    launched32 = fa.LAUNCHES - before
    print(f"[guided] f32 request (TF32 off): {wall32:.4f} s, {launched32} "
          f"attention launches; max |bf16 - f32| {(out - out32).abs().max().item():.3e}")
    check(launched32 == want, f"guided f32: {launched32} launches")
    got, plain = out32.float(), request(plain=True).float()
    err = (got - plain).abs().max().item()
    tol = MODEL_RTOL * max(1.0, plain.abs().max().item())
    print(f"[guided] f32 kernel vs plain-attention request: max_abs_err "
          f"{err:.3e} (tol {tol:.3e})")
    check(torch.isfinite(got).all().item(), "guided f32: non-finite sample")
    check(err <= tol, f"guided f32: request error {err} over {tol}")
    del request
    torch.cuda.empty_cache()
    return {"guided_serve": launched, "guided_serve_f32": launched32}


def _medseg_model(name: str, dtype):
    """``name`` at the JAX defaults, 256², the flagship's conditions, on the
    card in ``dtype`` with the weights of SEED."""
    model = build_model(name, device="cuda", in_channels=4, image_size=IMAGE,
                        dtype=dtype)
    return random_params(model, SEED)


def _medseg_sched():
    """The flagship's noise schedule as its trainer builds it (its net_mode
    follows the OpenAI math: 'linear' is scaled_linear), in full and
    re-spaced to DDIM_STEPS."""
    betas = schedules.make_beta_schedule(
        "scaled_linear", FLAGSHIP_CONFIG["diffusion_steps"],
        FLAGSHIP_CONFIG["linear_start"], FLAGSHIP_CONFIG["linear_end"])
    full = schedules.DiffusionSchedule.create(betas, device="cuda")
    rsched = schedules.respace(
        betas, schedules.space_timesteps(len(betas), str(DDIM_STEPS)),
        device="cuda")
    return full, rsched


def _medseg_parity(name: str) -> float:
    """Full-width forward, kernel vs plain attention, f32 (TF32 off) and
    bf16, batch PARITY_BATCH at 256²: the output and the seg map within the
    models' tolerances, MEDSEG_CALLS launches. Returns the parameter
    count."""
    disable_tf32()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    x = torch.randn(PARITY_BATCH, IMAGE, IMAGE, 4, generator=gen,
                    device="cuda")
    t = torch.tensor([17.0, 803.0], device="cuda")
    for dtype, rtol in ((torch.float32, MODEL_RTOL),
                        (torch.bfloat16, MODEL_BF16_RTOL)):
        model = _medseg_model(name, dtype).eval()
        n_params = sum(p.numel() for p in model.parameters())
        with torch.inference_mode():
            before = fa.LAUNCHES
            out, aux = model(x, t)
            torch.cuda.synchronize()
            launched = fa.LAUNCHES - before
            want, want_aux = _with_plain_attention(lambda: model(x, t))
        dname = str(dtype).split(".")[1]
        for what, got, ref in (("out", out, want),
                               ("cal", aux["cal"], want_aux["cal"])):
            got, ref = got.float(), ref.float()
            err = (got - ref).abs().max().item()
            tol = rtol * max(1.0, ref.abs().max().item())
            print(f"[medseg] {name} {n_params / 1e6:.2f} M params {IMAGE}² "
                  f"batch {PARITY_BATCH} {dname} ({fa.ROUTES[dtype]} route) "
                  f"{what}: max_abs_err {err:.3e} (tol {tol:.3e}), "
                  f"{launched} kernel launches")
            check(got.shape == (PARITY_BATCH, IMAGE, IMAGE, 1),
                  f"{name} {what}: shape {tuple(got.shape)}")
            check(torch.isfinite(got).all().item(),
                  f"{name} {dname} {what}: non-finite")
            check(err <= tol, f"{name} {dname} {what}: error {err} over {tol}")
        check(launched == MEDSEG_CALLS, f"{name} {dname}: {launched} "
              f"attention launches in a forward, not {MEDSEG_CALLS}")
        del model, out, aux, want, want_aux
    return n_params


def _medseg_request(name: str, rsched, smi: str) -> int:
    """One DDIM-20 request of batch SERVE_BATCH at 256², bf16, through
    ``make_sample_fn`` on the flagship's re-spaced schedule: shape, range,
    finite values, MEDSEG_CALLS launches a model call. Returns them."""
    model = _medseg_model(name, torch.bfloat16).eval()
    task = TaskConfig(parameterization="v", loss_type="charbonnier")
    fn = make_sample_fn(model, rsched, task, sampler="ddim")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    cond = torch.randn(SERVE_BATCH, IMAGE, IMAGE, 3, generator=gen,
                       device="cuda")
    fn(cond, gen)  # warm-up: cuDNN's first calls at these shapes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0  # count only the main path from here
    out, wall = _timed(lambda: fn(cond, gen))
    launched = fa.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = MEDSEG_CALLS * DDIM_STEPS
    print(f"[medseg] {name} DDIM-{DDIM_STEPS} request, batch {SERVE_BATCH}, "
          f"{IMAGE}², bf16: {wall:.4f} s, {SERVE_BATCH / wall:.3f} slices/s, "
          f"peak {peak:.3f} GiB, {launched} attention launches [{smi}]")
    _check_sample(out, SERVE_BATCH, IMAGE, True, f"{name} request")
    check(launched == want, f"{name}: {launched} launches, not {want}")
    del model
    return launched


def _medseg_train(name: str, sched, smi: str) -> int:
    """MEDSEG_TRAIN_STEPS bf16 steps (f32 master weights) at batch
    TRAIN_BATCH, 256², through ``make_train_step`` over a ``TrainState``:
    finite metrics, MEDSEG_CALLS launches a step; every tensor the loss
    reaches moved, every other one (MEDSEG_UNREACHED) took an exactly zero
    gradient (AdamW's first moment is zero) and kept its value. Returns the
    launches."""
    torch.backends.cudnn.allow_tf32 = True  # the default a user trains with
    model = _medseg_model(name, torch.bfloat16)
    state = TrainState(model, lambda p: make_optimizer(p, MEDSEG_LR))
    step = make_train_step(TaskConfig(parameterization="v",
                                      loss_type="charbonnier"), sched)
    sampler = ss.uniform_init(sched.num_timesteps, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    batch = {
        "target": torch.rand(TRAIN_BATCH, IMAGE, IMAGE, 1, generator=gen,
                             device="cuda") * 2 - 1,
        "image": torch.randn(TRAIN_BATCH, IMAGE, IMAGE, 3, generator=gen,
                             device="cuda"),
    }
    start = [p.detach().clone() for p in state.params]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0  # count only the main path from here
    times = []
    for i in range(MEDSEG_TRAIN_STEPS):
        before = fa.LAUNCHES
        (_, sampler, metrics), wall = _timed(
            lambda: step(state, sampler, batch, gen))
        times.append(wall)
        launched = fa.LAUNCHES - before
        vals = {k: v.item() for k, v in metrics.items()}
        print(f"[medseg] {name} train step {i + 1}: {wall * 1e3:.2f} ms, "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(vals.items()))
              + f", {launched} attention launches")
        check(all(math.isfinite(v) for v in vals.values()),
              f"{name}: non-finite metric at step {i + 1}: {vals}")
        check(launched == MEDSEG_CALLS, f"{name}: {launched} attention "
              f"launches in a train step, not {MEDSEG_CALLS}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    unreached = MEDSEG_UNREACHED[name]
    moved = still = 0
    for n, p0, p, mu in zip(state.names, start, state.params, state.tx.mu):
        if n.startswith(unreached):
            check(not mu.any().item() and torch.equal(p0, p),
                  f"{name}: {n} took a gradient the loss cannot give")
            still += 1
        else:
            check(not torch.equal(p0, p), f"{name}: {n} did not move")
            moved += 1
    step_ms = statistics.median(times[1:]) * 1e3
    print(f"[medseg] {name} train step {step_ms:.2f} ms (median of steps "
          f"2-{MEDSEG_TRAIN_STEPS}), {TRAIN_BATCH / step_ms * 1e3:.3f} "
          f"slices/s, peak {peak:.3f} GiB; {moved} tensors moved, {still} "
          f"under {unreached} took a zero gradient [{smi}]")
    check(still > 0, f"{name}: no tensor under {unreached}")
    del model, state, start
    return fa.LAUNCHES


def _sliding_window(smi: str) -> None:
    """SegUNet at its defaults, f32 (TF32 off), weights of SEED:
    ``sliding_window_probabilities`` over a synthetic SEG_VOLUME on the
    card, its wall, and the labels against the same call with the model on
    the CPU, equal wherever the CPU's two top probabilities are more than
    SEG_PROB_ATOL apart."""
    disable_tf32()
    seg = random_params(SegUNet().to("cuda"), SEED).eval()
    n_params = sum(p.numel() for p in seg.parameters())
    vol = np.random.default_rng(SEED + 17).standard_normal(SEG_VOLUME).astype(
        np.float32)
    args = dict(tile=SEG_TILE, overlap=SEG_OVERLAP, batch=SEG_BATCH)
    tiles = []

    def apply(model):
        def fn(x):
            tiles.append(tuple(x.shape))
            return model(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return fn

    with torch.inference_mode():
        sliding_window_probabilities(apply(seg), vol[:, :, :1], device="cuda",
                                     **args)  # warm-up
        tiles.clear()
        probs, wall = _timed(lambda: sliding_window_probabilities(
            apply(seg), vol, device="cuda", **args))
        calls = list(tiles)
        cpu = seg.to("cpu")
        t0 = time.perf_counter()
        want = sliding_window_probabilities(apply(cpu), vol, device="cpu",
                                            **args)
        cpu_wall = time.perf_counter() - t0
    labels, want_labels = probs.argmax(-1), want.argmax(-1)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > SEG_PROB_ATOL
    wrong = int((labels != want_labels)[clear].sum())
    perr = float(np.abs(probs - want).max())
    print(f"[medseg] SegUNet {n_params / 1e6:.2f} M params, f32: "
          f"sliding_window_inference over {list(SEG_VOLUME)}, tile "
          f"{SEG_TILE}, overlap {SEG_OVERLAP}, batch {SEG_BATCH}: {wall:.4f} "
          f"s on the card ({SEG_VOLUME[2] / wall:.3f} slices/s), {cpu_wall:.2f}"
          f" s on the CPU; {len(calls)} model calls of {sorted(set(calls))}; "
          f"max |p card - p cpu| {perr:.3e}; {wrong} labels differ where the "
          f"CPU's top two are more than {SEG_PROB_ATOL:.0e} apart "
          f"({int((~clear).sum())} voxels within it) [{smi}]")
    check(labels.shape == SEG_VOLUME[:3], f"labels {labels.shape}")
    check(set(np.unique(labels)) <= {0, 1}, "labels outside the classes")
    check(np.isfinite(probs).all(), "non-finite probabilities")
    check(len(calls) == 4 * -(-SEG_VOLUME[2] // SEG_BATCH),
          f"{len(calls)} tile calls")
    check(wrong == 0, f"sliding window: {wrong} labels differ from the CPU's")
    del seg, cpu


def _medseg_kernel_rows(card: str) -> list:
    """The attention kernel at MedSegDiff's shape, timed: bf16 at batch
    SERVE_BATCH and TRAIN_BATCH, f32 at the parity forward's batch."""
    disable_tf32()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    rows = []
    for dtype, batches in ((torch.bfloat16, (SERVE_BATCH, TRAIN_BATCH)),
                           (torch.float32, (PARITY_BATCH,))):
        for batch in batches:
            for N, H, D, calls in MEDSEG_ATTENTION:
                row = _attention_row(gen, batch, N, H, D, dtype, calls, card)
                rows.append(dict(row, path="medseg"))
    return rows


def phase_medseg(smi: str):
    """MedSegDiff in both modes at the JAX defaults, 256²: the kernel rows
    at its attention shape; per mode, full-width forward parity, one
    DDIM-20 request and three train steps; then SegUNet's sliding-window
    inference. Returns (rows, launches by path)."""
    rows = _medseg_kernel_rows(smi)
    full, rsched = _medseg_sched()
    launches = {}
    for name in MEDSEG_MODES:
        t0 = time.perf_counter()
        _medseg_parity(name)
        launches[f"{name}_serve"] = _medseg_request(name, rsched, smi)
        launches[f"{name}_train"] = _medseg_train(name, full, smi)
        torch.cuda.empty_cache()
        print(f"[medseg] {name} done in {time.perf_counter() - t0:.1f} s")
    _sliding_window(smi)
    torch.cuda.empty_cache()
    return rows, launches


def _adv_setup(dtype, batch: int):
    """The flagship DSUNet (remat, weights of SEED) in ``dtype``, its
    TrainState, the discriminator (weights of SEED + 1) and its state, the
    two steps on the flagship task, the schedule sampler and a batch of
    ``batch`` at 256²."""
    params = FLAGSHIP_CONFIG["unet_config"]["params"]
    model = random_params(build_model(
        "dsunet", device="cuda", in_channels=4, out_channels=2, dtype=dtype,
        remat=True, **params), SEED)
    disc = random_params(adversarial.ContentDiscriminator(
        ADV_CONTENT[-1], **ADV_DISC).to("cuda"), SEED + 1)
    lr = FLAGSHIP_CONFIG["lr"]
    ms = TrainState(model, lambda p: make_optimizer(p, lr))
    ds = TrainState(disc, lambda p: make_optimizer(p, lr))
    full, _ = _medseg_sched()
    steps = adversarial.make_adversarial_steps(
        _flagship_task(), full, adversarial.AdvConfig(**ADV_CONFIG))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    batch_ = {
        "target": torch.rand(batch, IMAGE, IMAGE, 1, generator=gen,
                             device="cuda") * 2 - 1,
        "image": torch.randn(batch, IMAGE, IMAGE, 3, generator=gen,
                             device="cuda"),
    }
    sampler = ss.uniform_init(full.num_timesteps, device="cuda")
    return ms, ds, steps, sampler, batch_, full, gen


def _adv_parity() -> None:
    """One f32 ``model_step`` (TF32 off) at batch PARITY_BATCH from the same
    states, kernel vs plain attention: the loss and loss_adv within
    TRAIN_LOSS_RTOL, every gradient (read off AdamW's first moment) within
    TRAIN_GRAD_RTOL of its leaf's scale."""
    disable_tf32()
    ms, ds, (model_step, _), sampler, batch, full, gen = _adv_setup(
        torch.float32, PARITY_BATCH)
    with torch.no_grad():
        _, feats = ms.model(torch.cat([batch["target"], batch["image"]], -1),
                            torch.tensor([17.0, 803.0], device="cuda"))
    shape = tuple(feats["content"].shape)
    check(shape == (ADV_CONTENT[0], PARITY_BATCH) + ADV_CONTENT[1:],
          f"content features {shape}")
    del feats
    t = torch.tensor([17, 803], device="cuda")
    noise = torch.randn(PARITY_BATCH, IMAGE, IMAGE, 1, generator=gen,
                        device="cuda")
    start = {n: p.detach().clone() for n, p in ms.model.named_parameters()}

    def run():
        ms.model.load_state_dict(start)
        ms.reset()
        before = fa.LAUNCHES
        _, _, metrics = model_step(ms, sampler, ds, batch, t=t, noise=noise)
        torch.cuda.synchronize()
        return ({k: v.item() for k, v in metrics.items()},
                [m / 0.1 for m in ms.tx.mu], fa.LAUNCHES - before)

    got, grads_k, launched = run()
    want, grads_p, _ = _with_plain_attention(run)
    top = max(g.abs().max().item() for g in grads_p)
    worst, worst_name = 0.0, ""
    for name, gk, gp in zip(ms.names, grads_k, grads_p):
        scale = max(gp.abs().max().item(), GRAD_NOISE_FLOOR * top)
        rel = (gk - gp).abs().max().item() / scale
        if rel > worst:
            worst, worst_name = rel, name
    rels = {k: abs(got[k] - want[k]) / abs(want[k]) for k in ("loss",
                                                               "loss_adv")}
    print(f"[adversarial] flagship DSUNet f32 remat, batch {PARITY_BATCH}, "
          f"content {shape}: loss {got['loss']:.6f} vs {want['loss']:.6f} "
          f"(rel {rels['loss']:.3e}), loss_adv {got['loss_adv']:.6f} vs "
          f"{want['loss_adv']:.6f} (rel {rels['loss_adv']:.3e}; tol "
          f"{TRAIN_LOSS_RTOL:.0e}); worst gradient error {worst:.3e} of its "
          f"leaf's scale at {worst_name} (tol {TRAIN_GRAD_RTOL:.0e}, "
          f"{len(ms.names)} leaves); {launched} kernel launches")
    check(launched == CALLS_PER_FORWARD, f"adversarial parity: {launched} "
          f"launches, not {CALLS_PER_FORWARD}")
    check(all(torch.isfinite(g).all().item() for g in grads_k),
          "adversarial: non-finite gradient")
    check(max(rels.values()) <= TRAIN_LOSS_RTOL, f"adversarial loss {rels}")
    check(worst <= TRAIN_GRAD_RTOL,
          f"adversarial gradient parity {worst} at {worst_name}")
    del ms, ds, grads_k, grads_p, start


def phase_adversarial(smi: str) -> dict:
    """Adversarial disentanglement on the flagship (93.56 M, remat) with the
    spectral-norm ContentDiscriminator: the f32 parity of one model step,
    then ADV_ROUNDS rounds of ``model_step`` + ``disc_step`` in bf16 at
    batch TRAIN_BATCH (walls, finite metrics, 0 <= disc_acc <= 1,
    CALLS_PER_FORWARD launches each), then ADV_ROUNDS plain flagship train
    steps on the same state for the wall beside them. Returns the
    launches."""
    _adv_parity()
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True  # the default a user trains with
    ms, ds, (model_step, disc_step), sampler, batch, full, gen = _adv_setup(
        torch.bfloat16, TRAIN_BATCH)
    n_model = sum(p.numel() for p in ms.params)
    n_disc = sum(p.numel() for p in ds.params)
    print(f"[adversarial] DSUNet {n_model / 1e6:.2f} M params bf16 remat, "
          f"ContentDiscriminator {n_disc / 1e6:.3f} M params {ADV_DISC}, "
          f"{ADV_CONFIG}, batch {TRAIN_BATCH}, {IMAGE}²")
    d0 = [p.detach().clone() for p in ds.params]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0  # count only the main path from here
    walls = []
    for r in range(ADV_ROUNDS):
        before = fa.LAUNCHES
        (_, sampler, metrics), m_wall = _timed(
            lambda: model_step(ms, sampler, ds, batch, gen))
        m_launched = fa.LAUNCHES - before
        (_, dmetrics), d_wall = _timed(lambda: disc_step(ds, ms, batch, gen))
        d_launched = fa.LAUNCHES - before - m_launched
        walls.append((m_wall, d_wall))
        vals = {k: v.item() for k, v in {**metrics, **dmetrics}.items()}
        print(f"[adversarial] round {r + 1}: model step {m_wall * 1e3:.2f} ms"
              f", disc step {d_wall * 1e3:.2f} ms, "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(vals.items()))
              + f", {m_launched} + {d_launched} attention launches")
        check(all(math.isfinite(v) for v in vals.values()),
              f"adversarial: non-finite metric in round {r + 1}: {vals}")
        check(0.0 <= vals["disc_acc"] <= 1.0, f"disc_acc {vals['disc_acc']}")
        check(m_launched == d_launched == CALLS_PER_FORWARD,
              f"adversarial: {m_launched} + {d_launched} launches, not "
              f"{CALLS_PER_FORWARD} each")
    launched = fa.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(any(not torch.equal(a, p) for a, p in zip(d0, ds.params)),
          "adversarial: the discriminator did not move")
    m_ms = statistics.median(w[0] for w in walls[1:]) * 1e3
    d_ms = statistics.median(w[1] for w in walls[1:]) * 1e3
    step = make_train_step(_flagship_task(), full)
    plain = []
    for _ in range(ADV_ROUNDS):
        _, wall = _timed(lambda: step(ms, sampler, batch, gen))
        plain.append(wall)
    plain_ms = statistics.median(plain[1:]) * 1e3
    print(f"[adversarial] round {m_ms + d_ms:.2f} ms (model step {m_ms:.2f} "
          f"+ disc step {d_ms:.2f}, medians of rounds 2-{ADV_ROUNDS}) against "
          f"the flagship train step's {plain_ms:.2f} ms on the same state "
          f"(median of steps 2-{ADV_ROUNDS}), {(m_ms + d_ms) / plain_ms:.3f}x;"
          f" peak {peak:.3f} GiB [{smi}]")
    del ms, ds, d0
    torch.cuda.empty_cache()
    return {"adversarial_train": launched}


def _per_forward(rows, key):
    """Sum of ``key`` over one serving forward's attention calls."""
    return sum(r[key] * r["calls_per_forward"] for r in rows)


def _family_forward(rows, shapes, key):
    """Sum of ``key`` over one forward of a family at batch SERVE_BATCH in
    bf16: its (N, heads, D, calls), each shape's row at that batch."""
    at = {tuple(r["shape"][1:]): r for r in rows
          if r["shape"][0] == SERVE_BATCH and r["dtype"] == "bfloat16"}
    return sum(at[(N, H, D)][key] * calls for N, H, D, calls in shapes)


def _latent_request(rows, key):
    """Sum of ``key`` over one latent request (batch SERVE_BATCH, bf16):
    the UNet's calls at each of the DDIM_STEPS steps, each condition's
    encode and the decode."""
    at = {tuple(r["shape"]): r for r in rows if r["dtype"] == "bfloat16"}
    unet = sum(at[(SERVE_BATCH, N, H, D)][key] * calls
               for N, H, D, calls in LATENT_ATTENTION_CALLS)
    vae = at[(SERVE_BATCH,) + VAE_ATTENTION][key]
    return DDIM_STEPS * unet + (LATENT_N_COND + 1) * vae


def kernels_line(attn_rows, attn_launches: dict, norm_rows,
                 norm_launches: int, latent_rows, transformer_rows,
                 medseg_rows) -> dict:
    """One entry per kernel. Attention: its work in one serving forward
    (batch SERVE_BATCH, bf16, 34 calls: the wgmma route), with its route for
    each dtype, and the same for one forward of each other family, for one
    latent request, each transformer-path shape's row (with the load its
    layout took) and each MedSegDiff row. GroupNorm+SiLU: one call at each flagship norm shape,
    batch SERVE_BATCH, bf16."""
    serve = [r for r in attn_rows if "families" not in r
             and r["shape"][0] == SERVE_BATCH and r["dtype"] == "bfloat16"]
    ops_ms = sum(r["bound_ms"] * r["calls_per_forward"] for r in serve
                 if r["bound_by"] == "operations")
    attn_bound = _per_forward(serve, "bound_ms")
    norm = [r for r in norm_rows
            if r["shape"][0] == SERVE_BATCH and r["dtype"] == "bfloat16"]
    keys = ("ms", "graph_ms", "plain_ms", "library_ms", "library_graph_ms",
            "bound_ms")
    per_family = {
        family: dict({k: _family_forward(attn_rows, shapes, k) for k in keys},
                     calls=sum(c for *_, c in shapes))
        for family, _, shapes in FAMILIES}
    return {"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "routes_by_dtype": {str(d).split(".")[1]: r for d, r in fa.ROUTES.items()},
        "source": "dsdiff_torch/ops/csrc/flash_attention.cu",
        "replaces": "dsdiff_tpu/ops/flash_attention.py:80",
        "launches": sum(attn_launches.values()),
        "launches_by_path": attn_launches,
        "max_abs_err": max(r["max_abs_err"] for r in attn_rows + latent_rows
                           + transformer_rows + medseg_rows),
        "ms": _per_forward(serve, "ms"),
        "graph_ms": _per_forward(serve, "graph_ms"),
        "plain_ms": _per_forward(serve, "plain_ms"),
        "bound_ms": attn_bound,
        "bound_by": "operations" if ops_ms > attn_bound / 2 else "bytes",
        "library_ms": _per_forward(serve, "library_ms"),
        "library_graph_ms": _per_forward(serve, "library_graph_ms"),
        "per": f"one DSUNet forward, batch {SERVE_BATCH}, bf16, "
               f"{CALLS_PER_FORWARD} calls",
        "per_family_forward": per_family,
        "per_latent_request": dict(
            {k: _latent_request(latent_rows, k) for k in keys},
            calls=LATENT_REQUEST_CALLS,
            per=f"DDIM-{DDIM_STEPS}, batch {SERVE_BATCH}, bf16: the latent "
                f"UNet's {LATENT_CALLS_PER_FORWARD} calls a step and "
                f"{LATENT_N_COND + 1} VAE calls at {list(VAE_ATTENTION)}"),
        "transformer_path_rows": [
            {k: r[k] for k in ("path", "shape", "keys", "dtype", "load",
                               "calls_per_forward", "max_abs_err", "ms",
                               "graph_ms", "plain_ms", "library_ms",
                               "library_graph_ms", "bound_ms", "bound_by",
                               "share_of_bound")}
            for r in transformer_rows],
        "medseg_rows": [
            {k: r[k] for k in ("path", "shape", "dtype", "route",
                               "calls_per_forward", "max_abs_err", "ms",
                               "graph_ms", "plain_ms", "library_ms",
                               "library_graph_ms", "bound_ms", "bound_by",
                               "share_of_bound")}
            for r in medseg_rows],
    }, {
        "name": "group_norm_silu",
        "route": "cuda",
        "source": "dsdiff_torch/ops/csrc/fused_norm.cu",
        "replaces": "dsdiff_tpu/ops/fused_norm.py:54",
        "launches": norm_launches,
        "max_abs_err": max(r["max_abs_err"] for r in norm),
        "ms": sum(r["ms"] for r in norm),
        "graph_ms": sum(r["graph_ms"] for r in norm),
        "plain_ms": sum(r["plain_ms"] for r in norm),
        "bound_ms": sum(r["bound_ms"] for r in norm),
        "bound_by": "bytes",
        "library_ms": sum(r["library_ms"] for r in norm),
        "library_graph_ms": sum(r["library_graph_ms"] for r in norm),
        "per": f"the whole op (statistics and apply, two launches), one call "
               f"at each of the {len(norm)} flagship ResBlock norm shapes, "
               f"batch {SERVE_BATCH}, bf16",
    }]}


PHASES = ("kernels", "norm", "serve", "split", "train", "fit", "int8",
          "cache", "dist", "families", "latent", "transformer_kernels",
          "transformer", "patched", "guided", "medseg", "adversarial")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {', '.join(PHASES)} "
                         f"(default all)")
    phases = ap.parse_args(argv).phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    t0 = time.perf_counter()
    name, count, smi = phase_device()
    phase_build()
    attn_rows = norm_rows = norm_launches = latent_rows = None
    transformer_rows = medseg_rows = None
    attn_launches = {}
    walls = peaks = ()
    if "kernels" in phases:
        attn_rows = phase_kernels(smi)
    if "norm" in phases:
        norm_rows = phase_norm_kernels(smi)
        norm_launches = phase_norm_op()
    if "serve" in phases:
        phase_model_parity()
        trainer, serve_launches, walls, peaks, first = phase_serve(smi)
        attn_launches["serve"] = serve_launches
        attn_launches["serve_samplers"] = phase_serve_samplers(trainer, first,
                                                               smi)
        del trainer, first
    if "split" in phases:
        phase_split_parity()
        attn_launches["serve_cached"] = phase_serve_cached(smi, walls, peaks)
    if "train" in phases:
        phase_train_parity()
        attn_launches["train"], attn_launches["serve_ema"] = phase_train(smi)
    if "fit" in phases:
        attn_launches.update(phase_fit(smi))
    try:
        if "int8" in phases:
            int8_rows, int8_launches, int8_convs = phase_int8(smi)
            attn_launches.update(int8_launches)
            print("[int8] conv rows " + json.dumps(
                {"int8_conv_launches": int8_convs, "rows": int8_rows}))
        if "cache" in phases:
            attn_launches.update(phase_cache(smi))
        if "dist" in phases:
            attn_launches.update(phase_dist(smi))
    finally:
        if "tmp" in _STORE:
            shutil.rmtree(_STORE.pop("tmp"), ignore_errors=True)
    if "families" in phases:
        attn_launches.update(phase_families(smi))
    if "latent" in phases:
        latent_rows, latent_launches = phase_latent(smi)
        attn_launches.update(latent_launches)
    if "transformer_kernels" in phases:
        transformer_rows = phase_transformer_kernels(smi)
    if "transformer" in phases:
        attn_launches.update(phase_transformer(smi))
    if "patched" in phases:
        attn_launches.update(phase_patched(smi))
    if "guided" in phases:
        attn_launches.update(phase_guided(smi))
    if "medseg" in phases:
        medseg_rows, medseg_launches = phase_medseg(smi)
        attn_launches.update(medseg_launches)
    if "adversarial" in phases:
        attn_launches.update(phase_adversarial(smi))
    print(f"[done] {'every phase' if len(phases) == len(PHASES) else phases} "
          f"passed in {time.perf_counter() - t0:.1f} s after the imports "
          f"[{smi}]")
    if len(set(phases)) == len(PHASES):
        print(json.dumps(kernels_line(attn_rows, attn_launches, norm_rows,
                                      norm_launches, latent_rows,
                                      transformer_rows, medseg_rows)))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
