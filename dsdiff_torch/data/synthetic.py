"""Structured synthetic multi-contrast dataset — the DS-Diff premise.

The reference's whole raison d'être is disentangled conditional synthesis:
contrasts of one patient share ANATOMY (content) but are rendered with
contrast-specific STYLE, and carry a LESION signal that is visible in some
contrasts and must be re-rendered (ring-enhanced) in the target
(model_architecture_thesis.md §disentanglement; DSUnetModel's input
decomposition [noise, anatomy, anatomy+lesion, lesion],
UNet_DS_Diff/model.py:654-663). Real patient data cannot ship in this
environment, so this module constructs a task with exactly that causal
structure, so that the disentangle losses have something real to separate:

- **Anatomy** (per case, shared across contrasts and slices with smooth
  z-variation): an elliptical "head" mask, two "ventricle" hypointensities,
  and a smooth intra-case texture field.
- **Style** (per case x contrast, the nuisance factor): a random monotone
  intensity remap (gain/gamma/bias) of the anatomy rendering. Val cases
  have styles never seen in training — a model must separate anatomy from
  rendering style to generalize.
- **Lesion** (per slice, independent of anatomy): small bright blobs.
  Channel A shows anatomy only (T1-like, lesion invisible); channel B shows
  anatomy + lesion (T2-like); channel C is lesion-weighted (DWI-like, faint
  anatomy). The target GT renders anatomy in a FIXED global style (the
  "contrast-enhanced" mapping, identical for all cases) plus a
  ring-enhanced lesion (bright dilated rim, medium core) — so the target
  style is learnable, the condition styles are nuisance, and the lesion
  must be extracted from B/C regardless of their styles.

Slices are written in the reference's H5 layout
(``images_{tr,ts}_{hw}/<case>/layer_<i>.h5``, preprocess/to_h5.py:27-51)
with keys A/B/C/GT, consumable by the standard Trainer data plane, or as
the npy case store of ``data/npy_dataset.py`` (``<case>/<key>.npy``, one
[S, H, W] stack per key), which needs no ``h5py``.

The port's own copy of the JAX package's ``data/synthetic.py``; the same
seed writes the same arrays.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from . import h5store, npy_dataset

__all__ = ["make_structured_case", "make_structured_dataset",
           "STYLE_PROFILES"]

# Style-nuisance profiles. 'mild' is the original task (scalar monotone
# remap per case x contrast; val styles are new draws from the SAME
# ranges). 'hard'/'hard_ood' add the two ingredients the reference's
# real multi-center MRI has and the mild task lacks
# (model_architecture_thesis.md's nuisance discussion):
#   * a smooth spatially-varying multiplicative bias field per
#     case x contrast (coil-inhomogeneity analogue) — style becomes
#     high-dimensional, so intensity-invariance alone cannot absorb it;
#   * per-case lesion rendering gain in B — lesion evidence must be read
#     out relative to the case's own style, not at an absolute level.
# 'hard_ood' additionally draws VAL styles from ranges disjoint from
# training (gamma and bias-field amplitude shifted up) — the
# out-of-distribution regime where separating anatomy from rendering
# style is the only route to generalization.
STYLE_PROFILES = {
    "mild": dict(gain=(0.7, 1.2), gamma=(0.6, 1.6), bias=(-0.05, 0.1),
                 field_amp=(0.0, 0.0), lesion_gain=(0.45, 0.45)),
    "hard": dict(gain=(0.6, 1.3), gamma=(0.45, 1.1), bias=(-0.08, 0.12),
                 field_amp=(0.15, 0.3), lesion_gain=(0.25, 0.6)),
    "hard_ood": dict(gain=(0.6, 1.3), gamma=(1.4, 2.2), bias=(-0.08, 0.12),
                     field_amp=(0.35, 0.5), lesion_gain=(0.25, 0.6)),
}


def _ellipse(hw: int, cy, cx, ry, rx, theta=0.0):
    y, x = np.mgrid[0:hw, 0:hw].astype(np.float32)
    y = y - cy
    x = x - cx
    ct, st = np.cos(theta), np.sin(theta)
    yr = ct * y + st * x
    xr = -st * y + ct * x
    return (yr / ry) ** 2 + (xr / rx) ** 2 <= 1.0


def _smooth(field: np.ndarray, sigma: float) -> np.ndarray:
    import scipy.ndimage as ndi

    return ndi.gaussian_filter(field, sigma).astype(np.float32)


def _style(v: np.ndarray, gain: float, gamma: float, bias: float):
    """Monotone intensity remap on [0,1] tissue values."""
    return np.clip(gain * np.power(np.clip(v, 0.0, 1.0), gamma) + bias,
                   0.0, 1.0)


def _bias_field(hw: int, rng: np.random.Generator, amp: float):
    """Smooth multiplicative gain field in [1-amp, 1+amp] (coil analogue)."""
    if amp <= 0.0:
        return np.ones((hw, hw), np.float32)
    f = _smooth(rng.normal(size=(hw, hw)).astype(np.float32), hw / 6.0)
    f = f / (np.abs(f).max() + 1e-6)
    return (1.0 + amp * f).astype(np.float32)


def make_structured_case(hw: int, rng: np.random.Generator, n_slices: int,
                         style_profile: str = "mild"):
    """One case: returns list of {A,B,C,GT} slice dicts in [-1, 1]."""
    import scipy.ndimage as ndi

    prof = STYLE_PROFILES[style_profile]

    # ---- anatomy (shared content; fixed within the case)
    c = hw / 2.0
    head_ry = hw * rng.uniform(0.33, 0.42)
    head_rx = hw * rng.uniform(0.28, 0.38)
    head = _ellipse(hw, c + rng.uniform(-2, 2), c + rng.uniform(-2, 2),
                    head_ry, head_rx)
    tex = _smooth(rng.normal(size=(hw, hw)).astype(np.float32), hw / 24.0)
    tex = 0.5 + 0.5 * tex / (np.abs(tex).max() + 1e-6)  # [0,1]
    vent = np.zeros((hw, hw), bool)
    for sx in (-1.0, 1.0):
        vent |= _ellipse(
            hw, c - hw * 0.05, c + sx * hw * 0.08,
            hw * rng.uniform(0.08, 0.13), hw * rng.uniform(0.03, 0.05),
            theta=sx * rng.uniform(0.2, 0.5),
        )
    vent &= head
    # cortex rim: distance-from-edge band
    inner = ndi.binary_erosion(head, iterations=max(hw // 42, 1))
    rim = head & ~inner

    # tissue value in [0,1]: texture inside head, ventricles dark, rim mid
    anatomy = np.where(head, 0.35 + 0.45 * tex, 0.0)
    anatomy = np.where(vent, 0.12, anatomy)
    anatomy = np.where(rim, 0.65, anatomy).astype(np.float32)

    # ---- per-case condition styles (nuisance; val cases get unseen draws)
    def draw(gain_rng=prof["gain"], gamma_rng=prof["gamma"],
             bias_rng=prof["bias"]):
        return (rng.uniform(*gain_rng), rng.uniform(*gamma_rng),
                rng.uniform(*bias_rng))

    styles = {
        "A": draw(),
        "B": draw(),
        "C": (rng.uniform(0.15, 0.3), rng.uniform(0.8, 1.2), 0.0),
    }
    # 'mild' consumes NO extra rng draws here, keeping its stream (and
    # therefore every previously recorded mild dataset) byte-identical.
    if style_profile == "mild":
        fields = {k: np.float32(1.0) for k in ("A", "B", "C")}
        lesion_gain_b = prof["lesion_gain"][0]
    else:
        fields = {k: _bias_field(hw, rng, rng.uniform(*prof["field_amp"]))
                  for k in ("A", "B", "C")}
        lesion_gain_b = rng.uniform(*prof["lesion_gain"])
    # target style is FIXED across the dataset (learnable global mapping)
    gt_style = (1.0, 0.85, 0.05)

    slices = []
    for _ in range(n_slices):
        # slight per-slice anatomy modulation (3D-ish continuity)
        warp = _smooth(rng.normal(size=(hw, hw)).astype(np.float32),
                       hw / 10.0)
        a_sl = np.clip(anatomy + 0.05 * warp * head, 0.0, 1.0)

        # ---- lesions (independent signal, per slice)
        lesion = np.zeros((hw, hw), np.float32)
        n_les = int(rng.integers(1, 4))
        for _k in range(n_les):
            while True:
                ly = rng.uniform(hw * 0.25, hw * 0.75)
                lx = rng.uniform(hw * 0.25, hw * 0.75)
                if inner[int(ly), int(lx)] and not vent[int(ly), int(lx)]:
                    break
            r = hw * rng.uniform(0.02, 0.05)
            blob = _ellipse(hw, ly, lx, r, r * rng.uniform(0.7, 1.3),
                            theta=rng.uniform(0, np.pi))
            lesion = np.maximum(
                lesion, blob.astype(np.float32) * rng.uniform(0.7, 1.0)
            )
        lesion = _smooth(lesion, 1.0)
        les_mask = lesion > 0.15
        ring = (ndi.binary_dilation(les_mask, iterations=max(hw // 86, 1))
                & ~ndi.binary_erosion(les_mask, iterations=1))

        # ---- render the four channels, then map [0,1] -> [-1,1]
        # (bias fields are identity under the 'mild' profile)
        chans = {}
        chans["A"] = np.clip(
            _style(a_sl, *styles["A"]) * fields["A"], 0.0, 1.0
        )  # lesion-blind
        chans["B"] = np.clip(
            _style(a_sl, *styles["B"]) * fields["B"]
            + lesion_gain_b * lesion, 0.0, 1.0
        )
        chans["C"] = np.clip(
            _style(a_sl, *styles["C"]) * fields["C"] + 0.9 * lesion,
            0.0, 1.0
        )
        gt = _style(a_sl, *gt_style)
        gt = np.where(ring, np.clip(gt + 0.5, 0, 1), gt)
        gt = np.where(les_mask & ~ring, np.clip(gt + 0.2, 0, 1), gt)
        chans["GT"] = gt
        slices.append({
            k: (2.0 * v - 1.0).astype(np.float32) for k, v in chans.items()
        })
    return slices


def make_structured_dataset(root, n_cases: int = 32, n_slices: int = 8,
                            hw: int = 256, seed: int = 0,
                            ts_fraction: float = 0.25,
                            style_profile: str = "mild",
                            ts_style_profile: str | None = None,
                            store: str = "h5"):
    """Write the dataset in the reference H5 layout; returns root.

    ``style_profile`` selects the nuisance regime (STYLE_PROFILES) for
    training cases; ``ts_style_profile`` (default: same) lets the test
    split draw from a different — e.g. 'hard_ood' — range for
    out-of-distribution evaluation of style robustness. ``store`` is
    'h5' (one ``layer_<i>.h5`` per slice) or 'npy' (one ``<key>.npy``
    stack per case and key).
    """
    if store not in ("h5", "npy"):
        raise ValueError(f"unknown store '{store}' (have 'h5', 'npy')")
    root = Path(root)
    rng = np.random.default_rng(seed)
    n_ts = max(int(n_cases * ts_fraction), 1)
    ts_style_profile = ts_style_profile or style_profile
    for ci in range(n_cases):
        case_rng = np.random.default_rng(rng.integers(2**63))
        split = "ts" if ci >= n_cases - n_ts else "tr"
        prof = ts_style_profile if split == "ts" else style_profile
        slices = make_structured_case(hw, case_rng, n_slices,
                                      style_profile=prof)
        case_dir = root / f"images_{split}_{hw}" / f"case{ci:03d}"
        if store == "npy":
            npy_dataset.write_case(case_dir, slices)
            continue
        for si, arrays in enumerate(slices):
            h5store.write_slice(case_dir / f"layer_{si}.h5", arrays)
    return root
