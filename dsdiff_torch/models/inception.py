"""InceptionV3 to the 2048-d pool3 features, for FID.

Port of the JAX package's ``models/inception.py`` on NCHW. The module names
are torchvision's (``Conv2d_1a_3x3.conv``, ``Mixed_5b.branch1x1.bn``, ...),
so a local ``pt_inception-2015-12-05`` (pytorch-fid) or torchvision
``inception_v3`` state dict loads by name; its ``fc.*`` and ``AuxLogits.*``
heads are not part of the trunk and are ignored.

As in the JAX package: BatchNorm eps is 1e-3; every 3x3 stride-1 average
pool leaves the padding out of its count (``count_include_pad=False``), in
both variants; ``variant='pt_fid'`` pools Mixed_7c's pool branch by max
(pytorch-fid's ``FIDInceptionE_2``), ``'torchvision'`` by average. Inputs
are NCHW in [-1, 1], resized to 299² by bilinear interpolation,
antialiased where a side shrinks (as ``jax.image.resize``'s "bilinear"
is).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import torch_io
from ..utils.device import resolve_device

__all__ = ["InceptionV3", "map_inception", "load_inception"]

INCEPTION_SIZE = 299


def _avg_pool3_nocount(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME average pool, the padding not counted."""
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=False)


class BasicConv2d(nn.Module):
    """Conv (no bias) -> BatchNorm (eps 1e-3, running statistics) -> ReLU."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3), stride=1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3, momentum=0.1)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, (1, 1))
        self.branch5x5_1 = BasicConv2d(cin, 48, (1, 1))
        self.branch5x5_2 = BasicConv2d(48, 64, (5, 5), padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool3_nocount(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, (3, 3), stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = F.max_pool2d(x, 3, 2)
        return torch.cat([b3, bd, bp], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, (1, 1))
        self.branch7x7_1 = BasicConv2d(cin, c7, (1, 1))
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, (1, 1))
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool3_nocount(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, (1, 1))
        self.branch3x3_2 = BasicConv2d(192, 320, (3, 3), stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, (1, 1))
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        bp = F.max_pool2d(x, 3, 2)
        return torch.cat([b3, b7, bp], dim=1)


class InceptionE(nn.Module):
    """``pool_mode`` 'avg' for Mixed_7b (and torchvision's Mixed_7c), 'max'
    for pytorch-fid's Mixed_7c."""

    def __init__(self, cin: int, pool_mode: str = "avg"):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv2d(cin, 320, (1, 1))
        self.branch3x3_1 = BasicConv2d(cin, 384, (1, 1))
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(448, 384, (3, 3), padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        if self.pool_mode == "max":
            bp = F.max_pool2d(x, 3, 1, padding=1)
        else:
            bp = _avg_pool3_nocount(x)
        bp = self.branch_pool(bp)
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3(nn.Module):
    """The trunk to the 2048-d pool3 features (no aux or fc head).
    ``variant`` 'pt_fid' (pytorch-fid's Mixed_7c max pool, the FID
    standard) or 'torchvision'. Frozen inference only: BatchNorm uses its
    running statistics."""

    def __init__(self, resize_input: bool = True, variant: str = "pt_fid"):
        super().__init__()
        if variant not in ("pt_fid", "torchvision"):
            raise ValueError(f"unknown inception variant '{variant}'")
        self.resize_input = resize_input
        self.variant = variant
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(
            2048, "max" if variant == "pt_fid" else "avg")
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 3, H, W] in [-1, 1] -> [B, 2048]."""
        size = (INCEPTION_SIZE, INCEPTION_SIZE)
        if self.resize_input and tuple(x.shape[2:]) != size:
            # the antialiased filter is plain bilinear where it grows, and
            # the plain kernel rounds closer to JAX's there
            x = F.interpolate(x, size=size, mode="bilinear",
                              align_corners=False,
                              antialias=max(x.shape[2:]) > INCEPTION_SIZE)
        h = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        h = F.max_pool2d(h, 3, 2)
        h = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(h))
        h = F.max_pool2d(h, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            h = getattr(self, name)(h)
        return h.mean(dim=(2, 3))


def _loaded_keys(net: nn.Module) -> set:
    """The state-dict keys a weight file must give (BatchNorm's
    ``num_batches_tracked`` counter is not a weight)."""
    return {k for k in net.state_dict()
            if not k.endswith("num_batches_tracked")}


def map_inception(sd: dict, net: nn.Module) -> dict:
    """A torchvision / pt-FID inception state dict -> the entries of
    ``net``'s state dict it holds (the heads and counters dropped)."""
    keys = _loaded_keys(net)
    return {k: torch.as_tensor(v, dtype=torch.float32)
            for k, v in sd.items() if k in keys}


def load_inception(path, resize_input: bool = True, variant: str = "pt_fid",
                   device=None) -> InceptionV3:
    """A local inception checkpoint (.pth, .safetensors, ...) -> a frozen
    ``InceptionV3`` in f32 on ``device`` (default ``"cuda"``). ``variant``
    'pt_fid' for ``pt_inception-2015-12-05`` weights, 'torchvision' for
    plain torchvision ``inception_v3`` ones. Raises if a weight is
    missing."""
    dev = resolve_device(device)
    net = InceptionV3(resize_input=resize_input, variant=variant)
    mapped = map_inception(torch_io.load_checkpoint(path), net)
    missing = sorted(_loaded_keys(net) - set(mapped))
    if missing:
        raise ValueError(
            f"inception weights incomplete: {len(missing)} missing, "
            f"e.g. {missing[:4]}")
    net.load_state_dict(mapped, strict=False)
    return net.to(dev).requires_grad_(False).eval()
