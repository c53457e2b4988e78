"""Perceptual feature distance: VGG16-LPIPS when weights exist locally, a
random-feature proxy otherwise.

Port of part of the JAX package's ``eval/perceptual.py``:

- ``VGG16Features``: the VGG16 trunk in torchvision's ``features`` layout,
  returning the five LPIPS slices (relu1_2, relu2_2, relu3_3, relu4_3,
  relu5_3);
- ``LPIPS``: per-layer unit-normalised feature differences, the ``lin``
  heads (or, without them, the uniform mean), summed over the layers;
  ``load_vgg16_lpips`` builds it from a local torchvision VGG16 state dict
  (``torch.load``), with the lin heads from the same file or another;
- ``PerceptualLoss``: the loss the VAE trainer calls. Real LPIPS where a
  local VGG16 checkpoint is given, otherwise a fixed random conv pyramid
  (``_FeaturePyramid``) initialised from ``seed``: random VGG-like features
  keep the metric's sensitivity to spatial frequency, and the VAE trains
  without weights the repository does not hold.

Inputs are NHWC in [-1, 1]; one-channel inputs are repeated to three.
Every network here is frozen: a distance is differentiable in its inputs
only. The RadImageNet ResNet50 backbone, the fake-3D distance and the
pickled-tree weights of the JAX package are not ported yet (ROADMAP A17b).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

__all__ = ["PerceptualLoss", "LPIPS", "VGG16Features", "load_vgg16_lpips",
           "map_lpips_lins"]

# torchvision VGG16 ``features`` conv indices per block
_VGG16_LAYOUT = (
    (64, (0, 2)),
    (128, (5, 7)),
    (256, (10, 12, 14)),
    (512, (17, 19, 21)),
    (512, (24, 26, 28)),
)

# LPIPS input scaling (ScalingLayer shift and scale, lpips/lpips.py)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit length over the channel axis (NCHW)."""
    return x / (torch.sqrt(torch.sum(x**2, dim=1, keepdim=True)) + eps)


def _three_channels(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW, one channel repeated to three."""
    x = x.permute(0, 3, 1, 2)
    return x.repeat(1, 3, 1, 1) if x.shape[1] == 1 else x


class VGG16Features(nn.Module):
    """VGG16 trunk emitting the five LPIPS feature slices (NCHW). Its
    ``conv{i}`` are torchvision's ``features.{i}``."""

    def __init__(self):
        super().__init__()
        c = 3
        for width, idxs in _VGG16_LAYOUT:
            for i in idxs:
                setattr(self, f"conv{i}", nn.Conv2d(c, width, 3, padding=1))
                c = width

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        h = x
        for b, (_, idxs) in enumerate(_VGG16_LAYOUT):
            for i in idxs:
                h = F.relu(getattr(self, f"conv{i}")(h))
            feats.append(h)
            if b < len(_VGG16_LAYOUT) - 1:
                h = F.max_pool2d(h, 2, 2)
        return feats


def map_lpips_lins(sd: dict) -> list[torch.Tensor | None]:
    """lpips ``lin{k}.model.1.weight`` [1, C, 1, 1] -> [C] vectors, from the
    standalone lpips weight files or taming's ``vgg.pth``
    (``lins.{k}.model.1.weight``); None where a head is absent."""
    lins = []
    for k in range(5):
        w = None
        for key in (f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight"):
            if key in sd:
                w = torch.as_tensor(sd[key], dtype=torch.float32).reshape(-1)
                break
        lins.append(w)
    return lins


class LPIPS:
    """Learned perceptual distance (Zhang et al. 2018), VGG backbone.
    ``lins``: the five head vectors (None: the uniform average, the
    'baseline' mode). ``net`` is frozen and stays where it is."""

    def __init__(self, net: VGG16Features, lins=None):
        self.net = net.requires_grad_(False).eval()
        self.lins = list(lins) if lins is not None else [None] * 5
        dev = next(net.parameters()).device
        self.lins = [None if w is None else w.to(dev) for w in self.lins]
        self._shift = torch.as_tensor(_SHIFT, device=dev)[:, None, None]
        self._scale = torch.as_tensor(_SCALE, device=dev)[:, None, None]

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Distances [B] between NHWC images ``x`` and ``y``."""
        fx = self.net((_three_channels(x) - self._shift) / self._scale)
        fy = self.net((_three_channels(y) - self._shift) / self._scale)
        total = 0.0
        for a, b, lin in zip(fx, fy, self.lins):
            d = (_normalize_tensor(a) - _normalize_tensor(b)) ** 2
            if lin is not None:
                total = total + torch.sum(
                    torch.mean(d * lin[:, None, None], dim=(2, 3)), dim=1)
            else:
                total = total + torch.mean(d, dim=(1, 2, 3))
        return total


def load_vgg16_lpips(vgg_path, lpips_path=None, device="cpu") -> LPIPS:
    """Real LPIPS from local torch checkpoint files: ``vgg_path`` a
    torchvision VGG16 state dict (``features.*``; may also carry the lin
    heads, taming's ``vgg.pth``), ``lpips_path`` an optional separate lpips
    head file. Raises if a VGG16 weight is missing."""
    sd = torch.load(vgg_path, map_location="cpu", weights_only=True)
    net = VGG16Features()
    mapped = {}
    for _, idxs in _VGG16_LAYOUT:
        for i in idxs:
            for leaf in ("weight", "bias"):
                if f"features.{i}.{leaf}" in sd:
                    mapped[f"conv{i}.{leaf}"] = sd[f"features.{i}.{leaf}"]
    missing = sorted(set(net.state_dict()) - set(mapped))
    if missing:
        raise ValueError(f"VGG16 weights incomplete: missing {missing[:5]}")
    net.load_state_dict(mapped)
    lins = map_lpips_lins(sd)
    if lpips_path:
        extra = map_lpips_lins(torch.load(lpips_path, map_location="cpu",
                                          weights_only=True))
        lins = [b if b is not None else a for a, b in zip(lins, extra)]
    return LPIPS(net.to(device), lins)


class _FeaturePyramid(nn.Module):
    """Four levels of two 3x3 conv + ReLU, 2x2 average pooling between."""

    def __init__(self, widths=(32, 64, 128, 256)):
        super().__init__()
        self.widths = tuple(widths)
        c = 3
        for i, w in enumerate(self.widths):
            setattr(self, f"conv{i}a", nn.Conv2d(c, w, 3, padding=1))
            setattr(self, f"conv{i}b", nn.Conv2d(w, w, 3, padding=1))
            c = w

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        h = x
        for i in range(len(self.widths)):
            h = F.relu(getattr(self, f"conv{i}a")(h))
            h = F.relu(getattr(self, f"conv{i}b")(h))
            feats.append(h)
            h = F.avg_pool2d(h, 2, 2)
        return feats


@torch.no_grad()
def _seeded_init(net: nn.Module, seed: int) -> nn.Module:
    """Kernels N(0, 1/fan_in) (the scale of Flax's lecun-normal default)
    drawn in name order from a CPU generator seeded ``seed``; zero biases.
    Not the JAX package's draws: tests carry its weights across."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in sorted(net.named_parameters()):
        if name.endswith("weight"):
            fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=gen) / fan_in**0.5)
        else:
            p.zero_()
    return net


class PerceptualLoss:
    """d(x, y) = sum over layers of mean((norm(f_l(x)) - norm(f_l(y)))²).

    ``weights_path``: a local torchvision VGG16 / taming ``vgg.pth``
    checkpoint gives real LPIPS (``lpips_path`` may supply the lin heads);
    None (or a path that does not exist) gives the random-feature proxy
    seeded ``seed``. Runs on ``device`` (default ``"cuda"``)."""

    def __init__(self, seed: int = 0, weights_path: str | None = None,
                 lpips_path: str | None = None, network_type: str = "lpips",
                 device=None):
        self.device = resolve_device(device or "cuda")
        self._lpips = None
        if weights_path and Path(weights_path).exists():
            if network_type != "lpips":
                raise NotImplementedError(
                    f"perceptual network_type '{network_type}' is not ported "
                    "yet (ROADMAP A17b)")
            self._lpips = load_vgg16_lpips(weights_path, lpips_path,
                                           self.device)
        else:
            self.net = _seeded_init(_FeaturePyramid(), seed).to(
                self.device).requires_grad_(False).eval()

    @property
    def is_real_lpips(self) -> bool:
        return self._lpips is not None

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Distances [B] between NHWC images ``x`` and ``y`` in [-1, 1]."""
        if self._lpips is not None:
            return self._lpips(x, y)
        fx = self.net(_three_channels(x))
        fy = self.net(_three_channels(y))
        total = 0.0
        for a, b in zip(fx, fy):
            d = (_normalize_tensor(a) - _normalize_tensor(b)) ** 2
            total = total + torch.mean(d, dim=(1, 2, 3))
        return total

    def distance_fn(self):
        """The distance as a plain function of (x, y), as the JAX package's
        steps take it."""
        return self
