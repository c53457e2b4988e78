"""Loss primitives: VLB math, Charbonnier, and the DS-Diff disentangle losses.

Port of the JAX package's ``core/losses.py:35-278``: plain tensor functions
with no module state.

- ``normal_kl`` / ``discretized_gaussian_log_likelihood``: the VLB helpers.
- ``charbonnier``: the per-element L1-Charbonnier regression loss.
- ``supervised_contrastive_loss``: SupCon over [B, n_views, ...] features with
  per-view labels; returns (loss, logits, perfect_logits).
- ``euclidean_disentangle_loss``: the pairwise-distance pull/push ratio
  ('eu' mode). The distance is written out as ``sqrt(max(|a|²+|b|²-2a·b, 0)
  + 1e-12)``, not ``torch.cdist``, whose gradient at coincident points and
  internal matmul path differ.
- ``disc_disentangle_loss``: DisC-Diff's common/distinct MSE ratio.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "mean_flat",
    "normal_kl",
    "approx_standard_normal_cdf",
    "discretized_gaussian_log_likelihood",
    "charbonnier",
    "supervised_contrastive_loss",
    "euclidean_disentangle_loss",
    "disentangle_loss",
    "ds_disentangle_losses",
    "disc_disentangle_loss",
]


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch axes."""
    return x.mean(dim=tuple(range(1, x.ndim)))


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N(mean1, e^logvar1) || N(mean2, e^logvar2)) elementwise, in nats."""
    return 0.5 * (
        -1.0
        + logvar2
        - logvar1
        + torch.exp(logvar1 - logvar2)
        + ((mean1 - mean2) ** 2) * torch.exp(-logvar2)
    )


def approx_standard_normal_cdf(x):
    """Tanh approximation of the standard normal CDF."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * x**3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of x in [-1, 1] under a discretized Gaussian (8-bit
    bins)."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    cdf_delta = cdf_plus - cdf_min
    return torch.where(
        x < -0.999,
        log_cdf_plus,
        torch.where(
            x > 0.999,
            log_one_minus_cdf_min,
            torch.log(torch.clamp(cdf_delta, min=1e-12)),
        ),
    )


def charbonnier(pred, target, eps: float = 1e-3):
    """Per-element L1-Charbonnier sqrt((x-y)^2 + eps^2); the caller
    reduces."""
    return torch.sqrt((pred - target) ** 2 + eps * eps)


def _flatten_views(features: torch.Tensor) -> torch.Tensor:
    """[b, n, ...] -> [n*b, D], view-major."""
    b, n = features.shape[0], features.shape[1]
    return features.reshape(b, n, -1).transpose(0, 1).reshape(n * b, -1)


def _flatten_view_labels(labels: torch.Tensor) -> torch.Tensor:
    """[b, n] -> [n*b], view-major."""
    return labels.transpose(0, 1).reshape(-1)


def _view_labels(labels: torch.Tensor, b: int, n: int) -> torch.Tensor:
    """[b] or [b, n] labels -> flat [n*b, 1]."""
    if labels.ndim == 1:
        labels = labels[:, None].expand(b, n)
    return _flatten_view_labels(labels)[:, None]


def supervised_contrastive_loss(
    features: torch.Tensor,
    labels: torch.Tensor,
    temperature: float = 0.1,
    base_temperature: float = 0.1,
):
    """SupCon (contrast_mode 'all') over per-view labels: cosine-similarity
    logits / temperature, self-contrast excluded from the positives and the
    denominator; loss = -(T/base_T) * mean over anchors of the mean
    log-probability of their positives. Returns (loss, logits,
    perfect_logits)."""
    b, n = features.shape[0], features.shape[1]
    flat_labels = _view_labels(labels, b, n)
    mask = (flat_labels == flat_labels.T).float()
    perfect_logit = 2.0 * mask - 1.0

    f = _flatten_views(features)
    f = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-12)
    logits = (f @ f.T) / temperature

    N = b * n
    logits_mask = 1.0 - torch.eye(N, dtype=torch.float32, device=f.device)
    pos_mask = mask * logits_mask
    # row-max subtraction for stability (the log-probabilities do not change)
    shifted = logits - logits.max(dim=1, keepdim=True).values.detach()
    exp_logits = torch.exp(shifted) * logits_mask
    log_prob = shifted - torch.log(exp_logits.sum(dim=1, keepdim=True))
    mean_log_prob_pos = (pos_mask * log_prob).sum(dim=1) / (
        pos_mask.sum(dim=1) + 1e-6
    )
    loss = -(temperature / base_temperature) * mean_log_prob_pos.mean()
    return loss, logits, perfect_logit


def euclidean_disentangle_loss(features: torch.Tensor, labels: torch.Tensor):
    """Pairwise-distance pull/push ratio ('eu' mode): flatten view-major,
    dist = ||f_i - f_j||_2 / D, loss = sum(dist over same-label off-diagonal
    pairs) / sum(dist over different-label pairs). Returns (loss, 2*dist - 1,
    perfect_logits)."""
    b, n = features.shape[0], features.shape[1]
    flat_labels = _view_labels(labels, b, n)
    f = _flatten_views(features)
    D = f.shape[1]
    sq = (f**2).sum(dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (f @ f.T)
    # jnp.maximum passes half the gradient at a tie; torch.clamp the whole of
    # it. They differ only for coincident features (d2 rounding to exactly 0).
    d2 = torch.clamp(d2, min=0.0)
    dist = torch.sqrt(d2 + 1e-12) / D
    same = (flat_labels == flat_labels.T).float()
    eye = torch.eye(f.shape[0], dtype=torch.float32, device=f.device)
    numerator = (dist * same * (1.0 - eye)).sum()
    denominator = (dist * (1.0 - same)).sum()
    loss = numerator / (denominator + 1e-12)
    return loss, dist * 2.0 - 1.0, 2.0 * same - 1.0


def disentangle_loss(
    features: torch.Tensor,
    labels: torch.Tensor,
    mode: str = "eu",
    temperature: float = 0.1,
):
    """'eu' | 'contrast' | 'eu&contrast' (the combined mode adds 0.05 x
    SupCon)."""
    if mode == "contrast":
        return supervised_contrastive_loss(features, labels, temperature,
                                           temperature)
    if mode == "eu":
        return euclidean_disentangle_loss(features, labels)
    if mode == "eu&contrast":
        l_c, logits, perfect = supervised_contrastive_loss(
            features, labels, temperature, temperature
        )
        l_e, _, _ = euclidean_disentangle_loss(features, labels)
        return l_e + 0.05 * l_c, logits, perfect
    raise ValueError(f"unknown disentangle mode '{mode}'")


def ds_disentangle_losses(
    features: dict,
    mode: str = "eu",
    temperature: float = 0.05,
):
    """The DS-Diff C-S and S-A-L disentangle objectives over the DSUNet
    feature dict (stream-major: content/style [3, B, ...], anatomy/lesion
    [2, B, ...]).

    - C-S: views = 3 contents + 3 styles, labels [b, b, b, -1, -2, -3].
    - S-A-L: views = 3 styles + 2 anatomy + 2 lesion, labels
      [-1, -2, -3, 2b, 2b, 2b+1, 2b+1].

    ``temperature`` reaches the C-S term only; the S-A-L term keeps
    ``disentangle_loss``'s default, as in the JAX package.
    Returns (c_s_loss, s_a_l_loss, logit dict for heatmaps).
    """
    def bm(x):  # stream-major [n, B, ...] -> [B, n, ...]
        return x.movedim(0, 1)

    content, style = bm(features["content"]), bm(features["style"])
    anatomy, lesion = bm(features["anatomy"]), bm(features["lesion"])
    B = content.shape[0]
    dev = content.device
    bidx = torch.arange(B, device=dev)

    c_lab = bidx[:, None].expand(B, content.shape[1])
    s_lab = (-1 - torch.arange(style.shape[1], device=dev))[None, :].expand(
        B, style.shape[1]
    )
    c_s_loss, cs_logit, cs_perfect = disentangle_loss(
        torch.cat([content, style], dim=1), torch.cat([c_lab, s_lab], dim=1),
        mode, temperature,
    )

    a_lab = (2 * bidx)[:, None].expand(B, anatomy.shape[1])
    l_lab = (2 * bidx + 1)[:, None].expand(B, lesion.shape[1])
    s_a_l_loss, sal_logit, sal_perfect = disentangle_loss(
        torch.cat([style, anatomy, lesion], dim=1),
        torch.cat([s_lab, a_lab, l_lab], dim=1), mode,
    )
    heatmaps = {
        "c_s": cs_logit, "c_s_perfect": cs_perfect,
        "s_a_l": sal_logit, "s_a_l_perfect": sal_perfect,
    }
    return c_s_loss, s_a_l_loss, heatmaps


def disc_disentangle_loss(features: dict) -> torch.Tensor:
    """DisC-Diff com/dist ratio over DiscUNet's features ([n, B, ...] each):
    the mean pairwise MSE between the streams' common features (pulled
    together) over that between their distinct features (pushed apart),
    + 1e-8."""
    com = features["common"]
    dist = features["distinct"]
    n = com.shape[0]

    def pair_mse(x):
        total, count = 0.0, 0
        for i in range(n):
            for j in range(i + 1, n):
                total = total + ((x[i] - x[j]) ** 2).mean()
                count += 1
        return total / max(count, 1)

    return pair_mse(com) / (pair_mse(dist) + 1e-8)
