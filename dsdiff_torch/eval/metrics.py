"""Evaluation metric library: SSIM family in torch, volume metrics on the
host.

Port of the JAX package's ``eval/metrics.py``, which re-implements the
reference's inference/test_metrics.py without ANTs, torchmetrics or skimage:

- ``scale12bit`` (:21-26): clip(((x - mean)/(std/400)) + 2048, 1e-10, 4095).
- ``nrmse`` (:149-160): RMSE / (max-min) over the mask.
- ``smape`` (:179-192), ``logac`` (:195-208), ``medsymac`` (:211-224): on
  12-bit rescaled voxels.
- ``psnr`` (:370-399): mask-cropped bounding box, data_range = max-min of GT.
- ``ssim`` / ``ms_ssim`` (:249-274): Wang et al. with the torchmetrics
  defaults (gaussian 11x11 sigma 1.5, k1=.01, k2=.03; MS-SSIM 5 scales,
  weights [.0448,.2856,.3001,.2363,.1333]); ``ms_ssim_volume`` is the
  reference's per-slice mean over the 12-bit, mask-cropped volume.
- ``nmi`` (:93-103) on 256-binned voxels; ``cc`` stands in for the ANTs
  neighborhood correlation; ``cw_ssim_*`` (:304-323); ``dice``
  (get_dice.py:14-71).

The SSIM family runs in torch on the tensors' device (validation on the
card); the Gaussian filter runs in full f32 with TF32 off, the port's
version of the JAX package's ``precision=HIGHEST``: with TF32 (about three
decimal digits) the moment cancellation ``E[x²] - E[x]²`` goes negative on
near-constant regions with ``|mean| ~ 1`` and SSIM can exceed 1. The
scalar accuracy metrics are numpy (host-side, offline reports).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import full_f32

__all__ = [
    "scale12bit",
    "nrmse",
    "smape",
    "logac",
    "medsymac",
    "psnr",
    "mae",
    "ssim",
    "ms_ssim",
    "ms_ssim_volume",
    "cw_ssim_slice",
    "cw_ssim_volume",
    "nmi",
    "cc",
    "dice",
    "evaluate_volume",
]


# ---------------------------------------------------------------- host-side
def scale12bit(img: np.ndarray) -> np.ndarray:
    new_mean, new_std = 2048.0, 400.0
    return np.clip(
        ((img - np.mean(img)) / (np.std(img) / new_std)) + new_mean,
        1e-10,
        4095,
    )


def _masked(t, p, mask):
    m = (
        np.ones_like(t, dtype=bool)
        if mask is None
        else np.asarray(mask).astype(bool)
    )
    return np.asarray(t)[m], np.asarray(p)[m]


def nrmse(true, pred, mask=None) -> float:
    t, p = _masked(true, pred, mask)
    rmse = float(np.sqrt(np.mean((t - p) ** 2)))
    return rmse / float(t.max() - t.min())


def smape(true, pred, mask=None) -> float:
    t, p = _masked(true, pred, mask)
    t, p = scale12bit(t), scale12bit(p)
    return float(np.mean(np.abs(p - t) / (np.abs(t) + np.abs(p))))


def logac(true, pred, mask=None) -> float:
    t, p = _masked(true, pred, mask)
    t, p = scale12bit(t), scale12bit(p)
    return float(np.mean(np.abs(np.log(p / t))))


def medsymac(true, pred, mask=None) -> float:
    t, p = _masked(true, pred, mask)
    t, p = scale12bit(t), scale12bit(p)
    return float(np.exp(np.median(np.abs(np.log(p / t)))) - 1.0)


def mae(true, pred, mask=None) -> float:
    t, p = _masked(true, pred, mask)
    return float(np.mean(np.abs(t - p)))


def _mask_bbox(arr, mask):
    if mask is None:
        return np.asarray(arr)
    nzi = np.nonzero(np.asarray(mask).astype(bool))
    sl = tuple(slice(int(z.min()), int(z.max())) for z in nzi)
    return np.asarray(arr)[sl]


def psnr(true, pred, mask=None) -> float:
    t = _mask_bbox(true, mask)
    p = _mask_bbox(pred, mask)
    data_range = float(t.max() - t.min())
    mse = float(np.mean((t.astype(np.float64) - p.astype(np.float64)) ** 2))
    return float(10.0 * np.log10(data_range**2 / mse))


def nmi(true, pred, mask=None, bins: int = 256) -> float:
    """Normalized mutual information 2*I/(H(t)+H(p)) on 256-scaled voxels."""
    t, p = _masked(true, pred, mask)

    def scale256(x):
        return (
            (x - x.min()) / (x.max() - x.min() + 1e-12) * 255
        ).astype(np.uint8)

    joint, _, _ = np.histogram2d(scale256(t), scale256(p), bins=bins)
    pxy = joint / joint.sum()
    px = pxy.sum(axis=1)
    py = pxy.sum(axis=0)

    def ent(q):
        q = q[q > 0]
        return -np.sum(q * np.log(q))

    hx, hy, hxy = ent(px), ent(py), ent(pxy.reshape(-1))
    mi = hx + hy - hxy
    return float(2.0 * mi / (hx + hy + 1e-12))


def cc(true, pred, mask=None) -> float:
    """Global correlation coefficient (stands in for the ANTs CC metric)."""
    t, p = _masked(true, pred, mask)
    t = t - t.mean()
    p = p - p.mean()
    return float(
        np.sum(t * p) / (np.sqrt(np.sum(t**2) * np.sum(p**2)) + 1e-12)
    )


def dice(seg_true, seg_pred, label: int = 1) -> float:
    """Dice overlap for one label (inference/get_dice.py:14-71)."""
    a = np.asarray(seg_true) == label
    b = np.asarray(seg_pred) == label
    denom = a.sum() + b.sum()
    if denom == 0:
        return 1.0
    return float(2.0 * np.logical_and(a, b).sum() / denom)


# ------------------------------------------------------------ SSIM family


def _gaussian_kernel(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


def _filter2d(img: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Valid-mode 2D correlation of img [B, H, W] with kern [k, k], f32."""
    with full_f32():
        return F.conv2d(img[:, None], kern[None, None])[:, 0]


def ssim(true: torch.Tensor, pred: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM per batch element; inputs [B, H, W] (or [H, W])."""
    t = true.float()
    p = pred.float()
    if t.ndim == 2:
        t, p = t[None], p[None]
    k = _gaussian_kernel(kernel_size, sigma, device=t.device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_t = _filter2d(t, k)
    mu_p = _filter2d(p, k)
    mu_tt = _filter2d(t * t, k)
    mu_pp = _filter2d(p * p, k)
    mu_tp = _filter2d(t * p, k)
    # true variances are >= 0; negative values are cancellation noise
    var_t = torch.clamp(mu_tt - mu_t**2, min=0.0)
    var_p = torch.clamp(mu_pp - mu_p**2, min=0.0)
    cov = mu_tp - mu_t * mu_p
    num = (2 * mu_t * mu_p + c1) * (2 * cov + c2)
    den = (mu_t**2 + mu_p**2 + c1) * (var_t + var_p + c2)
    return (num / den).mean(dim=(1, 2))


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _cs(t, p, k, c2):
    mu_t = _filter2d(t, k)
    mu_p = _filter2d(p, k)
    var_t = torch.clamp(_filter2d(t * t, k) - mu_t**2, min=0.0)
    var_p = torch.clamp(_filter2d(p * p, k) - mu_p**2, min=0.0)
    cov = _filter2d(t * p, k) - mu_t * mu_p
    return ((2 * cov + c2) / (var_t + var_p + c2)).mean(dim=(1, 2))


def _avgpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean over [B, H, W], odd trailing rows and columns dropped."""
    return F.avg_pool2d(x[:, None], 2)[:, 0]


def ms_ssim(true: torch.Tensor, pred: torch.Tensor, data_range: float = 1.0,
            kernel_size: int = 11, sigma: float = 1.5,
            levels: int = 5) -> torch.Tensor:
    """Multi-scale SSIM per batch element, inputs [B, H, W].

    H, W must stay >= kernel_size after (levels-1) halvings.
    """
    t = true.float()
    p = pred.float()
    if t.ndim == 2:
        t, p = t[None], p[None]
    k = _gaussian_kernel(kernel_size, sigma, device=t.device)
    c2 = (0.03 * data_range) ** 2
    weights = torch.tensor(_MSSSIM_WEIGHTS[:levels], device=t.device)
    vals = []
    for i in range(levels):
        if i == levels - 1:
            vals.append(torch.clamp(
                ssim(t, p, data_range, kernel_size, sigma), min=0.0))
        else:
            vals.append(torch.clamp(_cs(t, p, k, c2), min=0.0))
            t = _avgpool2(t)
            p = _avgpool2(p)
    stacked = torch.stack(vals)  # [levels, B]
    return torch.prod(stacked ** weights[:, None], dim=0)


def ms_ssim_volume(true, pred, mask=None) -> float:
    """Reference ssim_torch (:249-274): zero outside mask, crop to mask bbox,
    scale12bit, per-slice (axis 0) MS-SSIM, mean."""
    t = np.array(true, dtype=np.float64, copy=True)
    p = np.array(pred, dtype=np.float64, copy=True)
    if mask is not None:
        m = np.asarray(mask).astype(bool)
        t[~m] = 0
        p[~m] = 0
        t = _mask_bbox(t, m)
        p = _mask_bbox(p, m)
    t = scale12bit(t)
    p = scale12bit(p)
    data_range = 4095.0
    # per-slice over the z axis (our volumes are [x, y, z]; the reference's
    # sitk arrays are [z, y, x] sliced over axis 0 — same slices)
    tb = np.ascontiguousarray(np.moveaxis(t, -1, 0))
    pb = np.ascontiguousarray(np.moveaxis(p, -1, 0))
    # adapt the scale count to the in-plane size (each scale halves; the
    # 11x11 window must fit at the coarsest scale)
    min_hw = min(tb.shape[1], tb.shape[2])
    levels = 1
    while levels < 5 and (min_hw >> levels) >= 11:
        levels += 1
    vals = ms_ssim(
        torch.from_numpy(tb.astype(np.float32)),
        torch.from_numpy(pb.astype(np.float32)), data_range, levels=levels,
    )
    return float(vals.mean())


def _ricker(points: int, a: float) -> np.ndarray:
    """Mexican-hat wavelet (scipy.signal.ricker formula)."""
    A = 2.0 / (np.sqrt(3.0 * a) * np.pi**0.25)
    x = np.arange(points) - (points - 1.0) / 2.0
    xsq = (x / a) ** 2
    return A * (1.0 - xsq) * np.exp(-xsq / 2.0)


def _cwt_ricker(sig: np.ndarray, widths) -> np.ndarray:
    """Continuous wavelet transform rows (scipy.signal.cwt semantics:
    per width, same-mode convolution with ricker(min(10*w, len), w))."""
    from scipy.signal import fftconvolve

    out = np.empty((len(widths), sig.shape[0]), np.float64)
    for i, w in enumerate(widths):
        n = int(min(10 * w, sig.shape[0]))
        out[i] = fftconvolve(sig, _ricker(n, w), mode="same")
    return out


def cw_ssim_slice(true_img: np.ndarray, pred_img: np.ndarray,
                  width: int = 30, k: float = 0.01) -> float:
    """CW-SSIM of one 2D slice — the pyssim ``cw_ssim_value`` algorithm the
    reference calls (inference/test_metrics.py:304-323): ricker-CWT over the
    flattened pixel sequence, widths 1..30, magnitude + phase terms."""
    sig1 = np.asarray(true_img, np.float64).ravel()
    sig2 = np.asarray(pred_img, np.float64).ravel()
    widths = np.arange(1, width + 1)
    c1 = _cwt_ricker(sig1, widths)
    c2 = _cwt_ricker(sig2, widths)
    a1, a2 = np.abs(c1), np.abs(c2)
    num1 = 2.0 * np.sum(a1 * a2, axis=0) + k
    den1 = np.sum(a1**2, axis=0) + np.sum(a2**2, axis=0) + k
    prod = c1 * np.conjugate(c2)
    num2 = 2.0 * np.abs(np.sum(prod, axis=0)) + k
    den2 = 2.0 * np.sum(np.abs(prod), axis=0) + k
    return float(np.average((num1 / den1) * (num2 / den2)))


def cw_ssim_volume(true, pred, mask=None, width: int = 30) -> float:
    """Reference cw_ssim (test_metrics.py:304-323): crop to mask bbox, scale
    to 8-bit, per-slice CW-SSIM (z slices), mean."""
    t = np.array(true, dtype=np.float64, copy=True)
    p = np.array(pred, dtype=np.float64, copy=True)
    if mask is not None:
        m = np.asarray(mask).astype(bool)
        t = _mask_bbox(t, m)
        p = _mask_bbox(p, m)

    def scale256(x):
        rng = x.max() - x.min()
        return ((x - x.min()) / (rng if rng else 1.0) * 255.0).astype(
            np.uint8
        )

    t = scale256(t)
    p = scale256(p)
    vals = [
        cw_ssim_slice(t[..., z], p[..., z], width=width)
        for z in range(t.shape[-1])
    ]
    return float(np.mean(vals))


def evaluate_volume(true, pred, mask=None, with_cw_ssim: bool = True) -> dict:
    """The per-case metric row of inference/get_metric.py:16-132."""
    row = {
        "nrmse": nrmse(true, pred, mask),
        "smape": smape(true, pred, mask),
        "logac": logac(true, pred, mask),
        "medsymac": medsymac(true, pred, mask),
        "psnr": psnr(true, pred, mask),
        "mae": mae(true, pred, mask),
        "ms_ssim": ms_ssim_volume(true, pred, mask),
        "nmi": nmi(true, pred, mask),
        "cc": cc(true, pred, mask),
    }
    if with_cw_ssim:
        row["cw_ssim"] = cw_ssim_volume(true, pred, mask)
    return row
