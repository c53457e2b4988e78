"""Frechet distance metrics (FID) and pixel-domain VIF.

Port of the JAX package's ``eval/fid.py``; the numpy / scipy parts
(``FeatureStats``, ``frechet_distance``, ``vifp``) are copies of it.

- ``frechet_distance``: the Frechet / Wasserstein-2 distance between two
  feature Gaussians;
- ``FeatureStats``: streaming means and covariances of feature rows;
- ``make_inception_extractor``: the true pool3-2048 extractor from a local
  torchvision / pytorch-fid inception checkpoint (``models.inception``
  through ``utils.torch_io``), run on the card in f32;
- ``fid``: the distance through any extractor, by default the mean-pooled
  deepest level of the seed-0 random pyramid of ``eval.perceptual``
  (``proxy_extractor``) when no inception weights are on disk;
- ``vifp``: pixel-domain Visual Information Fidelity (Sheikh & Bovik), the
  standard multi-scale gaussian formulation, which needs no pretrained
  model.

Extractors map NHWC images in [-1, 1] (numpy or tensors) to numpy [B, D].
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

from ..utils.device import resolve_device

__all__ = [
    "FeatureStats",
    "frechet_distance",
    "fid",
    "vifp",
    "make_inception_extractor",
    "proxy_extractor",
]


def _nchw3(x, device) -> torch.Tensor:
    """NHWC images -> an f32 NCHW tensor on ``device``, one channel
    repeated to three."""
    xb = torch.as_tensor(x, dtype=torch.float32).to(device).permute(0, 3, 1, 2)
    return xb.repeat(1, 3, 1, 1) if xb.shape[1] == 1 else xb


def make_inception_extractor(weights_path, batch_resize: bool = True,
                             variant: str = "pt_fid", device=None):
    """True-FID extractor: [B, H, W, C] in [-1, 1] -> [B, 2048] pool3
    features (numpy f32) from a local inception checkpoint, on ``device``
    (default ``"cuda"``) in f32. TF32 stays as the caller set it."""
    from ..models.inception import load_inception

    dev = resolve_device(device)
    net = load_inception(weights_path, resize_input=batch_resize,
                         variant=variant, device=dev)

    @torch.inference_mode()
    def extractor(x):
        return net(_nchw3(x, dev)).cpu().numpy()

    return extractor


def proxy_extractor(perceptual):
    """The extractor of a random-pyramid ``PerceptualLoss``: its deepest
    feature level, mean-pooled over space."""

    @torch.inference_mode()
    def extractor(x):
        feats = perceptual.net(_nchw3(x, perceptual.device))
        return feats[-1].mean(dim=(2, 3)).cpu().numpy()

    return extractor


class FeatureStats:
    """Streaming mean/covariance over feature rows [N, D]."""

    def __init__(self, dim: int):
        self.n = 0
        self.sum = np.zeros(dim, np.float64)
        self.outer = np.zeros((dim, dim), np.float64)

    def update(self, feats: np.ndarray):
        f = np.asarray(feats, np.float64).reshape(-1, self.sum.shape[0])
        self.n += f.shape[0]
        self.sum += f.sum(axis=0)
        self.outer += f.T @ f

    @property
    def mean(self):
        return self.sum / max(self.n, 1)

    @property
    def cov(self):
        mu = self.mean
        return self.outer / max(self.n - 1, 1) - np.outer(mu, mu) * (
            self.n / max(self.n - 1, 1)
        )


def _psd_sqrt(c: np.ndarray) -> np.ndarray:
    """Symmetric PSD square root via eigendecomposition (negative eigvals
    from sampling noise are clipped to zero)."""
    w, v = np.linalg.eigh((c + c.T) / 2.0)
    return (v * np.sqrt(np.clip(w, 0.0, None))) @ v.T


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)).

    Tr(sqrt(C1 C2)) is computed as sum(sqrt(eigvals(S1 C2 S1))) with
    S1 = sqrt(C1): C1 C2 is similar to the symmetric PSD matrix S1 C2 S1,
    so their eigenvalues agree and the whole computation stays in real
    symmetric eigensolvers (scipy's general ``sqrtm(disp=False)`` is
    deprecated in 1.16 and removed in 1.18; it also needed a complex
    Schur pass on a matrix that is PSD-similar anyway)."""
    mu1, mu2 = np.asarray(mu1), np.asarray(mu2)
    cov1, cov2 = np.asarray(cov1), np.asarray(cov2)
    diff = mu1 - mu2

    def tr_sqrt_prod(c1, c2):
        s1 = _psd_sqrt(c1)
        w = np.linalg.eigvalsh((lambda m: (m + m.T) / 2.0)(s1 @ c2 @ s1))
        return float(np.sum(np.sqrt(np.clip(w, 0.0, None))))

    tr_covmean = tr_sqrt_prod(cov1, cov2)
    if not np.isfinite(tr_covmean):
        offset = np.eye(cov1.shape[0]) * eps
        tr_covmean = tr_sqrt_prod(cov1 + offset, cov2 + offset)
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2.0 * tr_covmean)


def fid(real_images, fake_images, extractor=None, batch: int = 16,
        device=None) -> float:
    """Frechet distance between pooled feature distributions.

    images: [N, H, W, C] float arrays in [-1, 1]. ``extractor`` maps a batch
    to [B, D] features; by default ``proxy_extractor`` of
    ``PerceptualLoss(seed=0)`` on ``device`` (default ``"cuda"``).
    """
    if extractor is None:
        from .perceptual import PerceptualLoss

        extractor = proxy_extractor(PerceptualLoss(seed=0, device=device))

    stats = []
    for images in (real_images, fake_images):
        images = np.asarray(images)
        first = extractor(images[:1])
        st = FeatureStats(first.shape[-1])
        for i in range(0, len(images), batch):
            st.update(extractor(images[i : i + batch]))
        stats.append(st)
    r, f = stats
    return frechet_distance(r.mean, r.cov, f.mean, f.cov)


def vifp(true, pred, sigma_nsq: float = 2.0, scales: int = 4) -> float:
    """Pixel-domain Visual Information Fidelity (Sheikh & Bovik 2006).

    Standard multi-scale formulation: per scale, gaussian-window local
    statistics give the gain g and residual sv; VIF = sum log(1 + g^2 s /
    (sv + n)) / sum log(1 + s / n). Identical images -> 1.0.
    """
    ref = np.asarray(true, np.float64)
    dist = np.asarray(pred, np.float64)
    if ref.ndim == 3:  # volume: accumulate over slices
        num = den = 0.0
        for z in range(ref.shape[-1]):
            n, d = _vifp_terms(ref[..., z], dist[..., z], sigma_nsq, scales)
            num += n
            den += d
        return float(num / (den + 1e-12))
    n, d = _vifp_terms(ref, dist, sigma_nsq, scales)
    return float(n / (d + 1e-12))


def _vifp_terms(ref, dist, sigma_nsq, scales):
    num = den = 0.0
    for scale in range(1, scales + 1):
        sd = 2.0 ** (scales - scale + 1) / 5.0
        if scale > 1:
            ref = ndimage.gaussian_filter(ref, sd)[::2, ::2]
            dist = ndimage.gaussian_filter(dist, sd)[::2, ::2]
        if min(ref.shape) < 8:
            break
        mu1 = ndimage.gaussian_filter(ref, sd)
        mu2 = ndimage.gaussian_filter(dist, sd)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        sigma1_sq = ndimage.gaussian_filter(ref * ref, sd) - mu1_sq
        sigma2_sq = ndimage.gaussian_filter(dist * dist, sd) - mu2_sq
        sigma12 = ndimage.gaussian_filter(ref * dist, sd) - mu1_mu2
        sigma1_sq = np.maximum(sigma1_sq, 0)
        sigma2_sq = np.maximum(sigma2_sq, 0)
        g = sigma12 / (sigma1_sq + 1e-10)
        sv_sq = sigma2_sq - g * sigma12
        g[sigma1_sq < 1e-10] = 0
        sv_sq[sigma1_sq < 1e-10] = sigma2_sq[sigma1_sq < 1e-10]
        sv_sq[g < 0] = sigma2_sq[g < 0]
        g = np.maximum(g, 0)
        sv_sq = np.maximum(sv_sq, 1e-10)
        num += np.sum(np.log10(1 + g * g * sigma1_sq / (sv_sq + sigma_nsq)))
        den += np.sum(np.log10(1 + sigma1_sq / sigma_nsq))
    return num, den
