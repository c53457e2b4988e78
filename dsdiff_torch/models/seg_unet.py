"""Segmentation networks and the MedSegDiff denoisers.

Port of the JAX package's ``models/seg_unet.py``:

- ``FFParser``: a learned complex filter in the frequency domain (f32
  ``rfft2`` over the spatial dims, times the weight, ``irfft2`` back at the
  input's size, cast back). Its weight is ``[C, H, W//2+1, 2]``, so the
  filter's size is fixed at construction (Flax fixes it at init) and any
  other input size raises.
- ``SegUNet``: nnU-Net's Generic_UNet as conv - instance norm - leaky-ReLU
  double blocks, strided downsampling, 2x2 transposed-conv upsampling and
  optional deep-supervision heads.
- ``HighwayUNet``: the SegUNet trunk on MedSegDiff's condition side, which
  gates its encoder with the diffusion U-Net's features (fuse mode) or
  hands out full-resolution anchor maps (anchor mode).
- ``MedSegDiffUNet``: the diffusion U-Net (``backbone``'s encoder, middle,
  decoder and out head) with a ``HighwayUNet``; returns ``(out, {"cal":
  seg map})``.
- ``sliding_window_inference``: Gaussian-weighted overlapping tiles over a
  volume, batched over z, accumulated on the host as in the JAX package
  (``sliding_window_probabilities`` returns the accumulated probabilities
  before the argmax).

Maps are NCHW inside; the models take and return NHWC at ``forward``.
Submodules carry the Flax names, so ``utils.flax_bridge`` maps weights one
to one (a ``ConvTranspose`` kernel by its module type: the Flax kernel is
the flipped torch one).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .backbone import OutHead, UNetDecoder, UNetEncoder, UNetMiddle
from .layers import Conv, TimeEmbed, _cast, zero_init

__all__ = ["FFParser", "SegUNet", "HighwayUNet", "MedSegDiffUNet",
           "sliding_window_probabilities", "sliding_window_inference"]

# Flax's GroupNorm / instance norm epsilon (torch's default is 1e-5)
_NORM_EPS = 1e-6


class FFParser(nn.Module):
    """x -> irfft2(rfft2(x) * W) over the spatial dims, in f32 with ortho
    norms, for inputs of ``channels`` x ``h`` x ``w`` only."""

    def __init__(self, channels: int, h: int, w: int):
        super().__init__()
        self.h, self.w = h, w
        self.complex_weight = nn.Parameter(
            0.02 * torch.randn(channels, h, w // 2 + 1, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[-2:]
        if (H, W) != (self.h, self.w):
            raise ValueError(f"FFParser built for {self.h}x{self.w} maps, "
                             f"got {H}x{W}")
        xf = torch.fft.rfft2(x.float(), dim=(-2, -1), norm="ortho")
        xf = xf * torch.view_as_complex(self.complex_weight)
        out = torch.fft.irfft2(xf, s=(H, W), dim=(-2, -1), norm="ortho")
        return out.to(x.dtype)


class ConvTranspose(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with f32 parameters that computes in
    ``dtype``."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.conv_transpose2d(x.to(cd), self.weight.to(cd),
                                  _cast(self.bias, cd), self.stride)


class _ConvBlock(nn.Module):
    """3x3 conv, instance norm (one channel a group, eps 1e-6, statistics
    and affine in f32), leaky-ReLU 0.01."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, 3, stride=stride,
                         padding=1, dtype=dtype)
        self.norm = nn.GroupNorm(out_channels, out_channels, eps=_NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)
        h = self.norm(h.float()).to(h.dtype)
        return F.leaky_relu(h, 0.01)


class _SegTrunk(nn.Module):
    """The encoder's double blocks, the bottleneck and the decoder's
    transposed convs and double blocks that SegUNet and HighwayUNet share:
    ``down_{lvl}_{a,b}``, ``bottleneck_{a,b}``, ``up_{lvl}_tr``,
    ``up_{lvl}_{a,b}``. The first block of a level takes ``stride``s[lvl]."""

    def _build(self, in_channels: int, base_features: int, num_pool: int,
               max_features: int, strides: Sequence[int], dtype) -> None:
        self.num_pool = num_pool
        self.feats = [min(base_features * 2**lvl, max_features)
                      for lvl in range(num_pool + 1)]
        ch = in_channels
        for lvl in range(num_pool):
            f = self.feats[lvl]
            self.add_module(f"down_{lvl}_a",
                            _ConvBlock(ch, f, strides[lvl], dtype))
            self.add_module(f"down_{lvl}_b", _ConvBlock(f, f, 1, dtype))
            ch = f
        f = self.feats[num_pool]
        self.bottleneck_a = _ConvBlock(ch, f, strides[num_pool], dtype)
        self.bottleneck_b = _ConvBlock(f, f, 1, dtype)
        ch = f
        for lvl in reversed(range(num_pool)):
            f = self.feats[lvl]
            self.add_module(f"up_{lvl}_tr", ConvTranspose(
                ch, f, 2, stride=2, dtype=dtype))
            self.add_module(f"up_{lvl}_a", _ConvBlock(2 * f, f, 1, dtype))
            self.add_module(f"up_{lvl}_b", _ConvBlock(f, f, 1, dtype))
            ch = f

    def _down(self, lvl: int, h: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"down_{lvl}_b")(getattr(self, f"down_{lvl}_a")(h))

    def _bottleneck(self, h: torch.Tensor) -> torch.Tensor:
        return self.bottleneck_b(self.bottleneck_a(h))

    def _up(self, lvl: int, h: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        h = getattr(self, f"up_{lvl}_tr")(h)
        h = torch.cat([h, skip.to(h.dtype)], dim=1)
        return getattr(self, f"up_{lvl}_b")(getattr(self, f"up_{lvl}_a")(h))


class SegUNet(_SegTrunk):
    """nnU-Net-style 2D segmenter: x [B, H, W, in] -> logits [B, H, W,
    classes] f32, or with ``deep_supervision`` one map a level, highest
    resolution first."""

    def __init__(self, in_channels: int = 1, num_classes: int = 2,
                 base_features: int = 32, num_pool: int = 5,
                 max_features: int = 320, deep_supervision: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.deep_supervision = deep_supervision
        self._build(in_channels, base_features, num_pool, max_features,
                    [1] + [2] * num_pool, dtype)
        for lvl in range(num_pool):
            if deep_supervision or lvl == 0:
                self.add_module(f"seg_{lvl}", Conv(
                    self.feats[lvl], num_classes, 1, dtype=dtype))

    def forward(self, x: torch.Tensor):
        h = x.permute(0, 3, 1, 2).to(self.dtype)
        skips = []
        for lvl in range(self.num_pool):
            h = self._down(lvl, h)
            skips.append(h)
        h = self._bottleneck(h)
        outs = []
        for lvl in reversed(range(self.num_pool)):
            h = self._up(lvl, h, skips[lvl])
            if self.deep_supervision or lvl == 0:
                seg = getattr(self, f"seg_{lvl}")(h).float()
                outs.append(seg.permute(0, 2, 3, 1))
        return outs[::-1] if self.deep_supervision else outs[-1]


class HighwayUNet(_SegTrunk):
    """MedSegDiff's condition-side network on NCHW maps.

    Fuse mode (``fuse_channels`` and ``fuse_sizes`` given: the width and
    (h, w) of each level's external feature): after each level's double
    block and 2x2 max pool, the external map is 1x1-projected
    (``hw_{lvl}_proj``), filtered by an ``FFParser`` (``hw_{lvl}_ff``) and
    turned into a spatial gate ``ha`` (1x1 conv, ``hw_{lvl}_gate``) and a
    channel gate ``hb`` (its spatial mean): ``h * ha * hb``. ``forward(x,
    hs)`` returns (the bottleneck's ``emb_proj`` [B, emb_dim, h', w'] f32,
    cal [B, classes, H, W] f32).

    Anchor mode (``anchor_out``; ``forward(x)``): returns (the decoder's
    maps at levels 1 and 0, level 1 bilinearly upsampled to full
    resolution, f32, highest resolution first; cal)."""

    def __init__(self, in_channels: int = 3, base_features: int = 32,
                 num_pool: int = 4, max_features: int = 320,
                 emb_dim: int = 512, num_classes: int = 1,
                 anchor_out: bool = False,
                 fuse_channels: Sequence[int] = (),
                 fuse_sizes: Sequence[tuple[int, int]] = (),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.anchor_out = anchor_out
        self._build(in_channels, base_features, num_pool, max_features,
                    [1] * (num_pool + 1), dtype)
        if len(fuse_channels) != len(fuse_sizes):
            raise ValueError("fuse_channels and fuse_sizes differ in length")
        self.n_fuse = len(fuse_channels)
        for lvl, (ch, (h, w)) in enumerate(zip(fuse_channels, fuse_sizes)):
            f = self.feats[lvl]
            self.add_module(f"hw_{lvl}_proj", Conv(ch, f, 1, dtype=dtype))
            self.add_module(f"hw_{lvl}_ff", FFParser(f, h, w))
            self.add_module(f"hw_{lvl}_gate", Conv(f, f, 1, dtype=dtype))
        self.emb_proj = Conv(self.feats[num_pool], emb_dim, 1, dtype=dtype)
        self.seg_out = Conv(self.feats[0], num_classes, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, hs: Sequence[torch.Tensor] | None = None):
        h = x.to(self.dtype)
        skips = []
        for lvl in range(self.num_pool):
            h = self._down(lvl, h)
            skips.append(h)
            # pool, then fuse: the diffusion features arrive downsampled
            h = F.max_pool2d(h, 2)
            if hs is not None and lvl < len(hs):
                if lvl >= self.n_fuse:
                    raise ValueError(f"no fusion built for level {lvl}")
                ext = getattr(self, f"hw_{lvl}_proj")(hs[lvl].to(self.dtype))
                ext = getattr(self, f"hw_{lvl}_ff")(ext)
                ha = getattr(self, f"hw_{lvl}_gate")(ext)
                hb = ext.mean(dim=(2, 3), keepdim=True)
                h = h * ha * hb
        h = self._bottleneck(h)
        emb = self.emb_proj(h)
        anchors = []
        for lvl in reversed(range(self.num_pool)):
            h = self._up(lvl, h, skips[lvl])
            if self.anchor_out and lvl <= 1:
                a = h
                if lvl > 0:
                    a = F.interpolate(a, scale_factor=2**lvl, mode="bilinear",
                                      align_corners=False)
                anchors.append(a.float())
        cal = self.seg_out(h).float()
        if self.anchor_out:
            return anchors[::-1], cal
        return emb.float(), cal


class MedSegDiffUNet(nn.Module):
    """MedSegDiff denoiser: x [B, H, W, xt + cond] NHWC (x_t first), t [B]
    -> (out [B, H, W, out] f32, {"cal": [B, H, W, 1] f32}).

    - ``mode='highway'``: the condition runs through a fuse-mode
      ``HighwayUNet`` gated by the encoder's skips after each downsample
      (skip ``(num_res_blocks + 1) * (d + 1)`` for level d), whose
      bottleneck embedding, resized to the encoder's output, enters through
      the 1x1 ``uemb_proj`` before the middle block.
    - ``mode='anchor'``: an anchor-mode highway on the condition alone; the
      zero-initialised 1x1 ``anchor_proj`` of its detached anchors
      ``[a0, a0, a1]`` is added to the in-conv's skip.

    Unlike Flax, the module needs its input widths and, in highway mode,
    its FFParsers' sizes up front: ``cond_channels`` condition channels
    and maps of ``image_size`` (an int, or (H, W))."""

    def __init__(self, xt_channels: int = 1, out_channels: int = 1,
                 model_channels: int = 32, num_res_blocks: int = 1,
                 attention_resolutions: Sequence[int] = (8,),
                 channel_mult: Sequence[int] = (1, 2, 4, 4),
                 num_heads: int = 4, mode: str = "highway",
                 highway_features: int = 32,
                 use_scale_shift_norm: bool = True, dropout: float = 0.0,
                 cond_channels: int = 3,
                 image_size: int | tuple[int, int] = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if mode not in ("highway", "anchor"):
            raise ValueError(f"unknown MedSegDiff mode '{mode}'")
        self.mode = mode
        self.xt_channels = xt_channels
        self.num_res_blocks = num_res_blocks
        common = dict(
            model_channels=model_channels, num_res_blocks=num_res_blocks,
            attention_resolutions=tuple(attention_resolutions),
            channel_mult=tuple(channel_mult), num_heads=num_heads,
            use_scale_shift_norm=use_scale_shift_norm, dropout=dropout,
            dtype=dtype,
        )
        self.time_embed = TimeEmbed(model_channels, 4 * model_channels,
                                    dtype=dtype)
        self.encoder = UNetEncoder(xt_channels + cond_channels, **common)
        n_pool = len(channel_mult) - 1
        self.n_pool = n_pool
        hw = dict(in_channels=cond_channels, base_features=highway_features,
                  num_pool=n_pool, dtype=dtype)
        if mode == "anchor":
            self.hwm = HighwayUNet(anchor_out=True, **hw)
            f = self.hwm.feats
            self.anchor_proj = zero_init(Conv(
                2 * f[0] + (f[1] if n_pool > 1 else f[0]), model_channels, 1,
                dtype=dtype))
        else:
            H, W = ((image_size, image_size) if isinstance(image_size, int)
                    else tuple(image_size))
            skip_ch = self.encoder.skip_channels
            self.hwm = HighwayUNet(
                fuse_channels=[skip_ch[self._fused_skip(d)]
                               for d in range(n_pool)],
                fuse_sizes=[(-(-H // 2**(d + 1)), -(-W // 2**(d + 1)))
                            for d in range(n_pool)], **hw)
            self.uemb_proj = Conv(self.hwm.emb_proj.out_channels,
                                  self.encoder.out_channels, 1, dtype=dtype)
        self.middle = UNetMiddle(self.encoder.out_channels, **common)
        self.decoder = UNetDecoder(self.encoder.out_channels,
                                   self.encoder.skip_channels, **common)
        self.out = OutHead(self.decoder.out_channels, out_channels, dtype)

    def _fused_skip(self, d: int) -> int:
        return (self.num_res_blocks + 1) * (d + 1)

    def forward(self, x: torch.Tensor, t: torch.Tensor):
        x = x.permute(0, 3, 1, 2)
        cond = x[:, self.xt_channels:]
        emb = self.time_embed(t)
        h, skips = self.encoder(x, emb)
        if self.mode == "anchor":
            anchors, cal = self.hwm(cond)
            a1 = anchors[1] if len(anchors) > 1 else anchors[0]
            anch = torch.cat([anchors[0], anchors[0], a1], dim=1)
            skips[0] = skips[0] + self.anchor_proj(anch.detach())
        else:
            per_level = [skips[self._fused_skip(d)] for d in range(self.n_pool)]
            uemb, cal = self.hwm(cond, per_level)
            uemb = F.interpolate(uemb, size=h.shape[-2:], mode="bilinear",
                                 align_corners=False)
            h = h + self.uemb_proj(uemb)
        h = self.middle(h, emb)
        h = self.decoder(h, skips, emb)
        out = self.out(h)
        return out.permute(0, 2, 3, 1), {"cal": cal.permute(0, 2, 3, 1)}


def _gaussian_importance(tile: int) -> np.ndarray:
    """Center-weighted tile mask (nnU-Net's): a Gaussian of sigma tile/8,
    peak 1."""
    x = np.arange(tile) - (tile - 1) / 2.0
    sigma = tile / 8.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    m = np.outer(g, g)
    return (m / m.max()).astype(np.float32)


def _starts(extent: int, tile: int, step: int) -> list[int]:
    last = max(extent - tile, 0)
    return sorted({min(s, last) for s in range(0, last + step, step)})


@torch.no_grad()
def sliding_window_probabilities(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    volume: np.ndarray,
    tile: int = 256,
    overlap: float = 0.5,
    num_classes: int = 2,
    batch: int = 8,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Tiled 2D inference over a [H, W, Z, C] volume -> class
    probabilities [H, W, Z, num_classes] f32.

    ``apply_fn`` maps NCHW tiles [batch, C, th, tw] on ``device`` (default
    ``"cuda"``) to logits [batch, num_classes, th, tw]. Tiles of ``tile``
    (clamped to the volume, which must leave them square, as in the JAX
    package) overlap by ``overlap``; each tile's slices go
    through in z-chunks of ``batch``, the last padded with zeros and the
    padding dropped. Softmax probabilities are weighted by a Gaussian of
    sigma tile/8 and accumulated on the host in f32, then divided by the
    summed weights."""
    dev = resolve_device(device)
    H, W, Z, C = volume.shape
    th, tw = min(tile, H), min(tile, W)
    if th != tw:
        # the JAX function's square Gaussian fails to broadcast there too
        raise ValueError(f"a {H}x{W} volume clamps the {tile}² tile to "
                         f"{th}x{tw}; the Gaussian weight is square")
    step = max(int(tile * (1 - overlap)), 1)
    xs, ys = _starts(H, tile, step), _starts(W, tile, step)
    gauss = _gaussian_importance(th)
    acc = np.zeros((H, W, Z, num_classes), np.float32)
    weight = np.zeros((H, W, 1, 1), np.float32)
    for x0 in xs:
        for y0 in ys:
            # [Z, C, th, tw]
            zbatch = np.ascontiguousarray(
                volume[x0:x0 + th, y0:y0 + tw].transpose(2, 3, 0, 1))
            probs = []
            for i in range(0, Z, batch):
                chunk = torch.from_numpy(zbatch[i:i + batch]).to(dev)
                n = chunk.shape[0]
                if n < batch:
                    chunk = torch.cat([chunk, chunk.new_zeros(
                        (batch - n,) + chunk.shape[1:])])
                p = torch.softmax(apply_fn(chunk).float(), dim=1)
                probs.append(p[:n].cpu().numpy())
            p = np.concatenate(probs).transpose(2, 3, 0, 1)  # [th, tw, Z, K]
            g = gauss[:th, :tw, None, None]
            acc[x0:x0 + th, y0:y0 + tw] += p * g
            weight[x0:x0 + th, y0:y0 + tw] += g
    return acc / np.maximum(weight, 1e-8)


def sliding_window_inference(apply_fn, volume: np.ndarray, tile: int = 256,
                             overlap: float = 0.5, num_classes: int = 2,
                             batch: int = 8,
                             device: str | torch.device = "cuda") -> np.ndarray:
    """[H, W, Z] labels: the argmax of ``sliding_window_probabilities``
    (the same arguments)."""
    return np.argmax(sliding_window_probabilities(
        apply_fn, volume, tile, overlap, num_classes, batch, device), axis=-1)
