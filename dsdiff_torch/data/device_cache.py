"""The whole train split on the card, with augmentation on the card.

Port of the JAX package's ``data/device_cache.py``: the split is uploaded
once (bf16 when the run computes in bf16) and every train batch is made on
the card: a uniform draw of indices with replacement, a gather, then per
sample a joint rotation of conditions and target by an angle in ±``max_deg``
degrees (bilinear, mirror border) and independent flips of each spatial
axis, each gated by ``aug_prob``. In the steady state no batch crosses from
the host.

The draws (``CacheDraws``: indices, rotation gates, angles, flip gates) are
separate from the work, so that a test can give JAX's; ``make_batch_fn``
draws them from an explicit ``torch.Generator`` on the cache's device.
``_rotate_one`` samples the input at ``cy + (y-cy)cos - (x-cx)sin``,
``cx + (y-cy)sin + (x-cx)cos`` about the pixel-grid centre, as the JAX
package's ``map_coordinates(order=1, mode='mirror')``: here
``F.grid_sample(mode='bilinear', padding_mode='reflection',
align_corners=True)``, which reflects about the edge pixels' centres too.

Against the host loader (``data/pipeline.BatchLoader``), as in the JAX
package: uniform draws with replacement, not epoch shuffles; the rotation's
border mirrors about the edge pixel (cv2's BORDER_REFLECT_101) where the
host chain's BORDER_REFLECT repeats it.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["CacheDraws", "DeviceCache", "rotate", "augment_pairs"]


@dataclasses.dataclass
class CacheDraws:
    """One batch's random draws, each [B] on the cache's device: ``idx``
    (int64 rows of the split), ``do_rot``, ``flip_h``, ``flip_w`` (bool)
    and ``angle`` (f32 radians)."""

    idx: torch.Tensor
    do_rot: torch.Tensor
    angle: torch.Tensor
    flip_h: torch.Tensor
    flip_w: torch.Tensor

    def rows(self, lo: int, hi: int) -> "CacheDraws":
        """The draws of batch rows ``lo:hi``."""
        return CacheDraws(*(getattr(self, f.name)[lo:hi]
                            for f in dataclasses.fields(self)))


def rotate(images: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Bilinear rotation of [B, H, W, C] f32 images, each by its ``angle``
    [B] radians, about the pixel-grid centre ((H-1)/2, (W-1)/2), mirror
    border."""
    B, H, W, _ = images.shape
    dev = images.device
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    ca = torch.cos(angle)[:, None, None]
    sa = torch.sin(angle)[:, None, None]
    # output pixel (y, x) samples the input at the inverse-rotated place
    src_y = cy + (yy - cy) * ca - (xx - cx) * sa
    src_x = cx + (yy - cy) * sa + (xx - cx) * ca
    grid = torch.stack([src_x * (2.0 / (W - 1)) - 1.0,
                        src_y * (2.0 / (H - 1)) - 1.0], dim=-1)
    out = F.grid_sample(images.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="reflection", align_corners=True)
    return out.permute(0, 2, 3, 1)


def _rotate_one(img: torch.Tensor, angle) -> torch.Tensor:
    """One [H, W, C] image rotated by ``angle`` radians (``rotate``)."""
    angle = torch.as_tensor(angle, dtype=torch.float32, device=img.device)
    return rotate(img[None], angle.reshape(1))[0]


def augment_pairs(image: torch.Tensor, target: torch.Tensor,
                  draws: CacheDraws):
    """Joint rotation (where ``do_rot``) then flips of the H axis (where
    ``flip_h``) and of the W axis (where ``flip_w``) of each (image [B, H, W,
    Ci], target [B, H, W, Ct]) pair; selects per sample, with no host
    synchronisation."""
    ci = image.shape[-1]
    both = torch.cat([image, target], dim=-1)
    B = both.shape[0]

    def pick(gate, changed, kept):
        return torch.where(gate.view(B, 1, 1, 1), changed, kept)

    both = pick(draws.do_rot, rotate(both, draws.angle), both)
    both = pick(draws.flip_h, both.flip(1), both)
    both = pick(draws.flip_w, both.flip(2), both)
    return both[..., :ci], both[..., ci:]


def _augment_pair(image: torch.Tensor, target: torch.Tensor, do_rot, angle,
                  flip_h, flip_w):
    """One (image [H, W, Ci], target [H, W, Ct]) pair, as the JAX package's
    ``_augment_pair`` given its draws: ``do_rot``, ``flip_h``, ``flip_w``
    bools and ``angle`` in radians."""
    both = torch.cat([image, target], dim=-1)
    if do_rot:
        both = _rotate_one(both, angle)
    if flip_h:
        both = both.flip(0)
    if flip_w:
        both = both.flip(1)
    ci = image.shape[-1]
    return both[..., :ci], both[..., ci:]


class DeviceCache:
    """The split as two device tensors, ``images`` [N, H, W, C_cond] and
    ``targets`` [N, H, W, 1], in ``dtype``; batches come out f32."""

    def __init__(self, images, targets, device="cuda",
                 dtype: torch.dtype = torch.float32):
        self.images = torch.as_tensor(np.asarray(images)).to(device, dtype)
        self.targets = torch.as_tensor(np.asarray(targets)).to(device, dtype)
        self.n = int(self.images.shape[0])
        self.device = self.images.device

    @classmethod
    def from_dataset(cls, ds, device="cuda", dtype=torch.float32,
                     max_bytes: int = 8 << 30) -> "DeviceCache":
        """The raw rows of a slice dataset (augmentation off while they are
        read: it runs on the card per batch). Raises ``ValueError`` when the
        split would take more than ``max_bytes`` on the card."""
        was_aug = ds.augment
        ds.augment = False
        try:
            rng = np.random.default_rng(0)
            rows = [ds.get(i, rng) for i in range(len(ds))]
        finally:
            ds.augment = was_aug
        images = np.stack([r["image"] for r in rows])
        targets = np.stack([r["target"] for r in rows])
        nbytes = (images.nbytes + targets.nbytes) // (
            2 if dtype == torch.bfloat16 else 1)
        if nbytes > max_bytes:
            raise ValueError(
                f"split needs {nbytes / 1e9:.1f} GB on device (> "
                f"{max_bytes / 1e9:.1f} GB cap); use the host BatchLoader "
                "for datasets that do not fit in device memory")
        return cls(images, targets, device=device, dtype=dtype)

    def draw(self, batch_size: int, generator: torch.Generator | None,
             aug_prob: float = 0.4, max_deg: float = 30.0) -> CacheDraws:
        """A batch's draws from ``generator`` (on the cache's device):
        indices uniform with replacement, then the gates and angles."""
        dev = self.device

        def uniform(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        idx = torch.randint(0, self.n, (batch_size,), generator=generator,
                            device=dev)
        do_rot = uniform(batch_size) < aug_prob
        angle = (uniform(batch_size) * (2 * max_deg) - max_deg) * (
            math.pi / 180.0)
        return CacheDraws(idx, do_rot, angle, uniform(batch_size) < aug_prob,
                          uniform(batch_size) < aug_prob)

    def batch(self, draws: CacheDraws, augment: bool = True) -> dict:
        """The gathered (and, with ``augment``, augmented) rows of
        ``draws``: ``{'image', 'target'}`` f32 and ``valid`` all true."""
        image = self.images.index_select(0, draws.idx).float()
        target = self.targets.index_select(0, draws.idx).float()
        if augment:
            image, target = augment_pairs(image, target, draws)
        return {"image": image, "target": target,
                "valid": torch.ones(draws.idx.shape, dtype=torch.bool,
                                    device=self.device)}

    def plain_batch(self, draws: CacheDraws, augment: bool = True) -> dict:
        """``batch`` one sample at a time (``_augment_pair``), the plain
        version it is held against."""
        images, targets = [], []
        for i, row in enumerate(draws.idx.tolist()):
            image = self.images[row].float()
            target = self.targets[row].float()
            if augment:
                image, target = _augment_pair(
                    image, target, bool(draws.do_rot[i]), draws.angle[i],
                    bool(draws.flip_h[i]), bool(draws.flip_w[i]))
            images.append(image)
            targets.append(target)
        return {"image": torch.stack(images), "target": torch.stack(targets),
                "valid": torch.ones(len(images), dtype=torch.bool,
                                    device=self.device)}

    def make_batch_fn(self, batch_size: int, augment: bool = True,
                      aug_prob: float = 0.4, max_deg: float = 30.0):
        """``fn(generator, rows=None) -> batch``: the draws of a global
        batch of ``batch_size`` from ``generator``, then the gather and
        augmentation of its rows ``rows`` (a ``(lo, hi)`` pair; all by
        default), so that each rank of a data-parallel run makes its own
        rows of one global batch."""

        def fn(generator, rows=None):
            draws = self.draw(batch_size, generator, aug_prob, max_deg)
            if rows is not None:
                draws = draws.rows(*rows)
            return self.batch(draws, augment)

        return fn
