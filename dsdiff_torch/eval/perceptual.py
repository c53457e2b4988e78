"""Perceptual feature distances: VGG16-LPIPS or a RadImageNet ResNet50 when
weights exist locally, a random-feature proxy otherwise.

Port of the JAX package's ``eval/perceptual.py``:

- ``VGG16Features``: the VGG16 trunk in torchvision's ``features`` layout,
  returning the five LPIPS slices (relu1_2, relu2_2, relu3_3, relu4_3,
  relu5_3);
- ``LPIPS``: per-layer unit-normalised feature differences, the ``lin``
  heads (or, without them, the uniform mean), summed over the layers;
  ``load_vgg16_lpips`` builds it from a local torchvision VGG16 file
  (``utils.torch_io``: .pth or .safetensors; ``map_vgg16``), with the lin
  heads from the same file or another;
- ``ResNet50Features`` / ``RadPerceptual``: the torchvision ResNet50 trunk
  (BatchNorm folded to a per-channel affine at load, ``map_resnet50``),
  its four layer outputs compared as LPIPS compares VGG's, on
  ImageNet-normalised inputs; ``load_resnet50_perceptual`` reads a
  torchvision / RadImageNet file (``model.``, ``backbone.`` or ``module.``
  prefixes stripped);
- ``fake_3d_distance``: a 2-D distance over the slices of 3-D volumes
  along each spatial axis, averaged over the axes;
- ``PerceptualLoss``: the loss the VAE trainer calls. Real LPIPS (or, with
  ``network_type`` 'radimagenet', 'radimagenet_resnet50' or 'resnet50',
  the ResNet50 distance) where a local checkpoint is given; a pickled
  random-pyramid tree of the JAX package (nested dicts of numpy arrays) if
  that load fails; otherwise a fixed random conv pyramid
  (``_FeaturePyramid``) initialised from ``seed``: random VGG-like features
  keep the metric's sensitivity to spatial frequency, and the VAE trains
  without weights the repository does not hold.

Inputs are NHWC in [-1, 1]; one-channel inputs are repeated to three.
Every network here is frozen: a distance is differentiable in its inputs
only.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import torch_io
from ..utils.device import resolve_device
from ..utils.flax_bridge import flax_to_state_dict

__all__ = ["PerceptualLoss", "LPIPS", "VGG16Features", "load_vgg16_lpips",
           "map_vgg16", "map_lpips_lins", "ResNet50Features", "RadPerceptual",
           "map_resnet50", "load_resnet50_perceptual", "fake_3d_distance"]

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


def map_vgg16(sd: dict) -> dict:
    """A torchvision VGG16 state dict -> ``VGG16Features``'s Flax paths
    (``params/conv{i}/kernel`` HWIO, ``params/conv{i}/bias``), as the JAX
    package maps it; ``utils.torch_io.assign`` puts them on the module."""
    out = {}
    for _, idxs in _VGG16_LAYOUT:
        for i in idxs:
            for suf in ("weight", "bias"):
                key = f"features.{i}.{suf}"
                if key in sd:
                    leaf, val = torch_io.to_flax(key, sd[key])
                    out[f"params/conv{i}/{leaf}"] = val
    return out


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


def load_vgg16_lpips(vgg_path, lpips_path=None, device=None) -> LPIPS:
    """Real LPIPS from local torch checkpoint files on ``device`` (default
    ``"cuda"``): ``vgg_path`` a torchvision VGG16 state dict
    (``features.*``; may also carry the lin heads, taming's ``vgg.pth``),
    ``lpips_path`` an optional separate lpips head file. Raises if a VGG16
    weight is missing."""
    dev = resolve_device(device)
    sd = torch_io.load_checkpoint(vgg_path)
    net = VGG16Features()
    state, missing, _ = torch_io.assign(net, map_vgg16(sd), make_fit=False)
    if missing:
        raise ValueError(f"VGG16 weights incomplete: missing {missing[:5]}")
    net.load_state_dict(state)
    lins = map_lpips_lins(sd)
    if lpips_path:
        extra = map_lpips_lins(torch_io.load_checkpoint(lpips_path))
        lins = [b if b is not None else a for a, b in zip(lins, extra)]
    return LPIPS(net.to(dev), lins)


_RESNET50_BLOCKS = (3, 4, 6, 3)
_RESNET50_MIDS = (64, 128, 256, 512)

# ImageNet normalisation (RadImageNet's training distribution)
_IMNET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMNET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class _AffineBN(nn.Module):
    """Inference BatchNorm folded to a per-channel affine (``weight`` the
    folded scale, ``bias`` the folded shift; ``_fold_bn`` at load)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return x * self.weight[:, None, None] + self.bias[:, None, None]


class _Bottleneck(nn.Module):
    """torchvision's Bottleneck; ``down_conv`` / ``down_bn`` are its
    ``downsample.0`` / ``downsample.1``."""

    def __init__(self, cin: int, mid: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out = mid * 4
        self.conv1 = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = _AffineBN(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = _AffineBN(mid)
        self.conv3 = nn.Conv2d(mid, out, 1, bias=False)
        self.bn3 = _AffineBN(out)
        self.downsample = downsample
        if downsample:
            self.down_conv = nn.Conv2d(cin, out, 1, stride=stride, bias=False)
            self.down_bn = _AffineBN(out)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        if self.downsample:
            x = self.down_bn(self.down_conv(x))
        return F.relu(h + x)


class ResNet50Features(nn.Module):
    """The torchvision ResNet50 trunk emitting its four layer outputs
    (NCHW): the RadImageNet perceptual backbone. Blocks are ``layer{l}_{b}``
    as in the JAX package; block 0 of each layer downsamples, with stride 2
    from layer 2 on."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _AffineBN(64)
        cin = 64
        for li, (n_blocks, mid) in enumerate(zip(_RESNET50_BLOCKS,
                                                 _RESNET50_MIDS)):
            for bi in range(n_blocks):
                stride = 2 if (bi == 0 and li > 0) else 1
                setattr(self, f"layer{li + 1}_{bi}",
                        _Bottleneck(cin, mid, stride, downsample=bi == 0))
                cin = mid * 4

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, 2, padding=1)  # pads with -inf
        feats = []
        for li, n_blocks in enumerate(_RESNET50_BLOCKS):
            for bi in range(n_blocks):
                h = getattr(self, f"layer{li + 1}_{bi}")(h)
            feats.append(h)
        return feats


def _fold_bn(sd, prefix: str, eps: float = 1e-5):
    """A torch BatchNorm's (scale, shift) at inference, in f32, folded with
    numpy as the JAX package folds it (torch's CPU ``sqrt`` rounds some
    values one ulp away from numpy's)."""
    g, b, m, v = (np.asarray(sd[f"{prefix}.{leaf}"], np.float32)
                  for leaf in ("weight", "bias", "running_mean",
                               "running_var"))
    scale = g / np.sqrt(v + eps)
    return torch.from_numpy(scale), torch.from_numpy(b - m * scale)


def map_resnet50(sd: dict) -> dict:
    """A torchvision ResNet50 state dict -> ``ResNet50Features``'s, the
    BatchNorms folded into ``_AffineBN``."""
    out = {}

    def conv(name, key):
        out[f"{name}.weight"] = torch.as_tensor(sd[key], dtype=torch.float32)

    def bn(name, prefix):
        out[f"{name}.weight"], out[f"{name}.bias"] = _fold_bn(sd, prefix)

    conv("conv1", "conv1.weight")
    bn("bn1", "bn1")
    for li, n_blocks in enumerate(_RESNET50_BLOCKS):
        for bi in range(n_blocks):
            t, f = f"layer{li + 1}.{bi}", f"layer{li + 1}_{bi}"
            for j in (1, 2, 3):
                conv(f"{f}.conv{j}", f"{t}.conv{j}.weight")
                bn(f"{f}.bn{j}", f"{t}.bn{j}")
            if f"{t}.downsample.0.weight" in sd:
                conv(f"{f}.down_conv", f"{t}.downsample.0.weight")
                bn(f"{f}.down_bn", f"{t}.downsample.1")
    return out


class RadPerceptual:
    """RadImageNet-style perceptual distance over ResNet50 layer features:
    channel-normalised per-layer squared differences, the mean over
    channels and space, summed over the four layers. ``net`` is frozen and
    stays where it is."""

    def __init__(self, net: ResNet50Features):
        self.net = net.requires_grad_(False).eval()
        dev = next(net.parameters()).device
        self._mean = torch.as_tensor(_IMNET_MEAN, device=dev)[:, None, None]
        self._std = torch.as_tensor(_IMNET_STD, device=dev)[:, None, None]

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Distances [B] between NHWC images ``x`` and ``y`` in [-1, 1]."""
        fx = self.net(((_three_channels(x) + 1.0) * 0.5 - self._mean)
                      / self._std)
        fy = self.net(((_three_channels(y) + 1.0) * 0.5 - self._mean)
                      / self._std)
        total = 0.0
        for a, b in zip(fx, fy):
            d = (_normalize_tensor(a) - _normalize_tensor(b)) ** 2
            total = total + torch.mean(d, dim=(1, 2, 3))
        return total


def load_resnet50_perceptual(path, device=None) -> RadPerceptual:
    """The RadImageNet / ResNet50 perceptual distance from a local
    torchvision-format checkpoint (.pth or .safetensors), on ``device``
    (default ``"cuda"``). Raises if a weight is missing."""
    dev = resolve_device(device)
    sd = torch_io.load_checkpoint(path)
    for pref in ("model.", "backbone.", "module."):
        if any(k.startswith(pref) for k in sd):
            sd = {k[len(pref):] if k.startswith(pref) else k: v
                  for k, v in sd.items()}
    try:
        mapped = map_resnet50(sd)
    except KeyError as e:
        raise ValueError(f"ResNet50 weights incomplete: missing {e}") from e
    net = ResNet50Features()
    net.load_state_dict(mapped)
    return RadPerceptual(net.to(dev))


def fake_3d_distance(distance_fn, x: torch.Tensor, y: torch.Tensor,
                     axes=(0, 1, 2), ratio: float = 1.0,
                     seed: int = 0) -> torch.Tensor:
    """Score 3-D volumes [B, H, W, D] by a 2-D ``distance_fn`` ((x2d, y2d)
    [N, h, w, 1] -> [N]) over slices along each spatial axis in ``axes``:
    the slicing axis moved to position 1, ``n_keep = round(S * ratio)``
    (at least one) evenly strided slices ``(arange(n_keep) * S // n_keep +
    seed) % S`` folded into the batch, their distances averaged per volume,
    then over the axes. Returns [B]."""
    if x.ndim != 4:
        raise ValueError(f"expect [B, H, W, D] volumes, not {tuple(x.shape)}")
    totals = []
    for ax in axes:
        perm = [0, 1 + ax] + [i + 1 for i in range(3) if i != ax]
        xv, yv = x.permute(perm), y.permute(perm)
        B, S = xv.shape[:2]
        n_keep = max(int(round(S * ratio)), 1)
        idx = (torch.arange(n_keep, device=x.device) * S // n_keep
               + seed) % S
        xs = xv[:, idx].reshape((B * n_keep,) + tuple(xv.shape[2:]) + (1,))
        ys = yv[:, idx].reshape((B * n_keep,) + tuple(yv.shape[2:]) + (1,))
        totals.append(distance_fn(xs, ys).reshape(B, n_keep).mean(dim=1))
    return torch.stack(totals).mean(dim=0)


_RESNET50_TYPES = ("radimagenet", "radimagenet_resnet50", "resnet50")


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

    ``weights_path``, tried in the JAX package's order: with
    ``network_type`` 'radimagenet', 'radimagenet_resnet50' or 'resnet50' a
    torchvision / RadImageNet ResNet50 checkpoint (``RadPerceptual``), with
    any other a torchvision VGG16 / taming ``vgg.pth`` checkpoint (real
    LPIPS; ``lpips_path`` may supply the lin heads); if that load raises, a
    pickled random-pyramid tree (``{"params": {conv0a: {kernel, bias},
    ...}}`` of numpy arrays, carried over by ``utils.flax_bridge``; a
    pickle runs code as it loads, so give only files of your own). None
    (or a path that does not exist) gives the random-feature proxy seeded
    ``seed``. Runs on ``device`` (default ``"cuda"``)."""

    def __init__(self, seed: int = 0, weights_path: str | None = None,
                 lpips_path: str | None = None, network_type: str = "lpips",
                 device=None):
        self.device = resolve_device(device)
        self._lpips = None
        if weights_path and Path(weights_path).exists():
            try:
                if network_type in _RESNET50_TYPES:
                    self._lpips = load_resnet50_perceptual(weights_path,
                                                           self.device)
                else:
                    self._lpips = load_vgg16_lpips(weights_path, lpips_path,
                                                   self.device)
            except Exception:
                with open(weights_path, "rb") as f:
                    legacy = pickle.load(f)
                net = _FeaturePyramid()
                net.load_state_dict(flax_to_state_dict(legacy, net))
                self.net = self._frozen(net)
        else:
            self.net = self._frozen(_seeded_init(_FeaturePyramid(), seed))

    def _frozen(self, net: nn.Module) -> nn.Module:
        return net.to(self.device).requires_grad_(False).eval()

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
