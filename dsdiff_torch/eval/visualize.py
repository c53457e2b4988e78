"""Result analysis/visualization: metric plots, difference maps, t-SNE,
pixel profiles.

Re-design of the visualize_result/ script collection (SURVEY.md §2.6, L7):
box/bar plots over per-case metric reports, GT-vs-pred difference maps,
t-SNE of disentangled bottleneck features, and pixel-intensity profile
curves. All host-side matplotlib (Agg backend); each function writes a PNG
and returns the path.

The port's own copy of the JAX package's ``eval/visualize.py``. matplotlib
(and sklearn for ``tsne_features``) is imported inside the functions, so
the rest of the port imports where it is not installed.
"""
from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

__all__ = [
    "load_metric_csv",
    "metric_boxplot",
    "metric_barplot",
    "difference_map",
    "tsne_features",
    "pixel_profile",
    "disentangle_heatmaps",
    "image_grid",
    "denoise_row",
]


def _plt():
    """matplotlib.pyplot on the Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def load_metric_csv(path) -> dict:
    """metric CSV (eval.assemble.write_metric_report) -> {metric: [values]}
    excluding the mean row."""
    cols: dict[str, list] = {}
    with open(path) as f:
        for row in csv.DictReader(f):
            if row.get("case") == "mean":
                continue
            for k, v in row.items():
                if k == "case":
                    continue
                cols.setdefault(k, []).append(float(v))
    return cols


def metric_boxplot(reports: dict, metric: str, out_path) -> Path:
    """Box plot of one metric across methods ({label: csv_path})."""
    plt = _plt()
    labels, data = [], []
    for label, path in reports.items():
        cols = load_metric_csv(path)
        if metric in cols:
            labels.append(label)
            data.append(cols[metric])
    fig, ax = plt.subplots(figsize=(1.5 * max(len(labels), 2) + 2, 4))
    ax.boxplot(data, tick_labels=labels)
    ax.set_ylabel(metric)
    ax.set_title(f"{metric} per case")
    return _save(fig, out_path)


def metric_barplot(reports: dict, metrics: list, out_path) -> Path:
    """Grouped mean-bar plot across methods."""
    plt = _plt()
    labels = list(reports)
    fig, ax = plt.subplots(figsize=(2 + 1.2 * len(metrics) * len(labels) / 2, 4))
    width = 0.8 / max(len(labels), 1)
    x = np.arange(len(metrics))
    for i, label in enumerate(labels):
        cols = load_metric_csv(reports[label])
        means = [float(np.mean(cols.get(m, [np.nan]))) for m in metrics]
        ax.bar(x + i * width, means, width, label=label)
    ax.set_xticks(x + width * (len(labels) - 1) / 2)
    ax.set_xticklabels(metrics)
    ax.legend()
    return _save(fig, out_path)


def difference_map(gt: np.ndarray, pred: np.ndarray, out_path,
                   slice_idx: int | None = None) -> Path:
    """GT | pred | |diff| triptych for one slice (difference-map scripts)."""
    plt = _plt()
    gt = np.asarray(gt)
    pred = np.asarray(pred)
    if gt.ndim == 3:
        slice_idx = slice_idx if slice_idx is not None else gt.shape[2] // 2
        gt = gt[:, :, slice_idx]
        pred = pred[:, :, slice_idx]
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, img, title, cmap in [
        (axes[0], gt, "ground truth", "gray"),
        (axes[1], pred, "prediction", "gray"),
        (axes[2], np.abs(gt - pred), "|difference|", "inferno"),
    ]:
        im = ax.imshow(img.T, cmap=cmap, origin="lower")
        ax.set_title(title)
        ax.axis("off")
        fig.colorbar(im, ax=ax, fraction=0.046)
    return _save(fig, out_path)


def tsne_features(features: dict, out_path, perplexity: float = 10.0,
                  seed: int = 0, max_points: int = 2000) -> Path:
    """t-SNE of disentangled feature groups ({group: [N, ...] arrays}),
    one color per group (feature t-SNE scripts)."""
    plt = _plt()
    from sklearn.manifold import TSNE

    xs, labels = [], []
    for name, arr in features.items():
        a = np.asarray(arr)
        a = a.reshape(a.shape[0] * (a.shape[1] if a.ndim > 2 else 1), -1) \
            if a.ndim > 2 else a.reshape(a.shape[0], -1)
        xs.append(a)
        labels += [name] * a.shape[0]
    X = np.concatenate(xs)
    if X.shape[0] > max_points:
        idx = np.random.default_rng(seed).choice(
            X.shape[0], max_points, replace=False)
        X = X[idx]
        labels = [labels[i] for i in idx]
    emb = TSNE(
        n_components=2, perplexity=min(perplexity, max(X.shape[0] - 2, 1)),
        random_state=seed, init="pca",
    ).fit_transform(X)
    fig, ax = plt.subplots(figsize=(6, 6))
    for name in dict.fromkeys(labels):
        m = np.array([l == name for l in labels])
        ax.scatter(emb[m, 0], emb[m, 1], s=8, label=name, alpha=0.7)
    ax.legend()
    ax.set_title("t-SNE of disentangled features")
    return _save(fig, out_path)


def pixel_profile(volumes: dict, row: int, out_path,
                  slice_idx: int | None = None) -> Path:
    """Intensity profile along one image row for several volumes
    ({label: [H, W(, Z)]} — the interactive pixel-profile viewer's static
    form)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 4))
    for label, vol in volumes.items():
        v = np.asarray(vol)
        if v.ndim == 3:
            v = v[:, :, slice_idx if slice_idx is not None else v.shape[2] // 2]
        ax.plot(v[row], label=label, linewidth=1)
    ax.set_xlabel("column")
    ax.set_ylabel("intensity")
    ax.set_title(f"pixel profile @ row {row}")
    ax.legend()
    return _save(fig, out_path)


def _save(fig, out_path) -> Path:
    plt = _plt()
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def disentangle_heatmaps(features: dict, out_dir, mode: str = "eu",
                         temperature: float = 0.05):
    """Render the C-S and S-A-L similarity heatmaps with their 'perfect'
    targets (the reference logs these images each training step,
    trainer_use_gaussian_diff.py:472-475 / gaussian_diffusion.py:960-974).

    ``features``: a DSUNet feature dict of tensors (e.g. captured from one
    forward). Writes four PNGs and returns their paths.
    """
    plt = _plt()
    from ..core.losses import ds_disentangle_losses
    from ..utils.misc import heatmap_to_rgb

    _, _, hm = ds_disentangle_losses(features, mode, temperature)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for name in ("c_s", "c_s_perfect", "s_a_l", "s_a_l_perfect"):
        rgb = heatmap_to_rgb(hm[name].detach().float().cpu().numpy())
        fig, ax = plt.subplots(figsize=(4, 4))
        ax.imshow(rgb)
        ax.set_title(name)
        ax.axis("off")
        paths.append(_save(fig, out_dir / f"heatmap_{name}.png"))
    return paths


def _to_unit(img: np.ndarray) -> np.ndarray:
    lo, hi = float(img.min()), float(img.max())
    return (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)


def image_grid(named_images: dict, out_path, max_rows: int = 4) -> Path:
    """Save a labeled grid: one column per entry (conds / GT / prediction),
    one row per batch element — the reference's per-val-epoch real/fake
    sample logging (trainer_ds_diff.py:649-696, log_images).

    ``named_images``: {label: [B, H, W] or [B, H, W, C] arrays}; channels >1
    are split into their own columns.
    """
    plt = _plt()
    cols = []
    for label, arr in named_images.items():
        arr = np.asarray(arr)
        if arr.ndim == 4:
            for c in range(arr.shape[-1]):
                cols.append((f"{label}[{c}]" if arr.shape[-1] > 1 else label,
                             arr[..., c]))
        else:
            cols.append((label, arr))
    rows = min(max_rows, cols[0][1].shape[0])
    fig, axes = plt.subplots(rows, len(cols),
                             figsize=(1.6 * len(cols), 1.6 * rows),
                             squeeze=False)
    for j, (label, arr) in enumerate(cols):
        for i in range(rows):
            ax = axes[i][j]
            ax.imshow(_to_unit(arr[i]), cmap="gray")
            ax.axis("off")
            if i == 0:
                ax.set_title(label, fontsize=7)
    return _save(fig, out_path)


def denoise_row(x0_frames: np.ndarray, out_path, max_frames: int = 8,
                max_rows: int = 2) -> Path:
    """Save the progressive-denoising row: intermediate x0 predictions along
    the reverse chain (trainer_ds_diff log_images 'denoise_row' /
    LatentDiffusion progressive denoising, ddpm.py:1117).

    ``x0_frames``: [T, B, H, W] or [T, B, H, W, 1], ordered t=T-1 .. 0.
    """
    plt = _plt()
    frames = np.asarray(x0_frames)
    if frames.ndim == 5:
        frames = frames[..., 0]
    T = frames.shape[0]
    keep = np.linspace(0, T - 1, min(max_frames, T)).astype(int)
    rows = min(max_rows, frames.shape[1])
    fig, axes = plt.subplots(rows, len(keep),
                             figsize=(1.6 * len(keep), 1.6 * rows),
                             squeeze=False)
    for j, fidx in enumerate(keep):
        for i in range(rows):
            ax = axes[i][j]
            ax.imshow(_to_unit(frames[fidx, i]), cmap="gray")
            ax.axis("off")
            if i == 0:
                ax.set_title(f"step {fidx}", fontsize=7)
    return _save(fig, out_path)
