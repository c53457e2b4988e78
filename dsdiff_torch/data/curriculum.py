"""Shannon-entropy curriculum sampling for warm-up epochs.

The port's own copy of the JAX package's ``data/curriculum.py``.

Re-design of the reference's entropy curriculum
(Disc_diff/guided_diffusion/image_datasets.py:111-143 entropy-bucketed index
dict; train_util.py:192-228 / trainer_use_gaussian_diff.py:172-234 truncated-
normal batch extraction with the bucket mean annealed low -> high over the
warm-up iterations): easy (low-entropy) slices are shown first, the
truncated-normal center sweeps toward hard slices linearly in step/warmup.
"""
from __future__ import annotations

import numpy as np
from scipy import stats as sstats

__all__ = ["shannon_entropy", "EntropyCurriculum"]


def shannon_entropy(img: np.ndarray, bins: int = 256) -> float:
    """Histogram Shannon entropy in bits (skimage.measure.shannon_entropy
    semantics, which the reference imports)."""
    # skimage computes over the exact gray values; histogram over finite bins
    # is equivalent for discrete data and robust for float inputs
    hist, _ = np.histogram(img.reshape(-1), bins=bins)
    p = hist.astype(np.float64)
    p = p[p > 0]
    p = p / p.sum()
    return float(-np.sum(p * np.log2(p)))


class EntropyCurriculum:
    """Bucketed curriculum over a SliceDataset.

    ``dataset.get`` rows supply the target slice used for the entropy score
    (the reference scores the CE/gt volume). Use :meth:`sample_indices` for
    the first ``warmup_steps`` optimizer steps, then fall back to the normal
    shuffled loader (train_util.py:217-228).
    """

    def __init__(self, dataset, seed: int = 0, max_items: int | None = None):
        self.ds = dataset
        rng = np.random.default_rng(seed)
        self.buckets: dict[float, list[int]] = {}
        n = len(dataset) if max_items is None else min(len(dataset), max_items)
        for i in range(n):
            row = dataset.get(i, rng)
            e = round(shannon_entropy(row["target"]))
            self.buckets.setdefault(e, []).append(i)
        self.lowest = min(self.buckets)
        self.highest = max(self.buckets)
        self.sd = 0.5

    def mean_at(self, step: int, warmup_steps: int) -> float:
        """Linear low->high anneal (train_util.py:225-227)."""
        frac = min(max(step / max(warmup_steps, 1), 0.0), 1.0)
        return self.lowest * (1 - frac) + self.highest * frac

    def sample_indices(
        self, batch_size: int, step: int, warmup_steps: int,
        rng: np.random.Generator,
    ) -> list[int]:
        """Truncated-normal draw over buckets (_extract_batch,
        train_util.py:192-215)."""
        mean = self.mean_at(step, warmup_steps)
        if self.highest <= self.lowest:
            # degenerate: every slice in one entropy bucket
            draws = np.full(batch_size, self.lowest)
        else:
            a = (self.lowest - mean) / self.sd
            b = (self.highest - mean) / self.sd
            draws = np.round(
                sstats.truncnorm.rvs(
                    a, b, loc=mean, scale=self.sd, size=batch_size,
                    random_state=rng,
                )
            )
        out: list[int] = []
        for val, count in zip(*np.unique(draws, return_counts=True)):
            bucket = self.buckets.get(float(val))
            if not bucket:
                # nearest existing bucket
                keys = np.array(sorted(self.buckets))
                bucket = self.buckets[float(
                    keys[np.argmin(np.abs(keys - val))]
                )]
            count = min(int(count), len(bucket))
            out.extend(rng.choice(bucket, size=count, replace=False).tolist())
        return out

    def batch(self, batch_size: int, step: int, warmup_steps: int,
              rng: np.random.Generator) -> dict:
        idxs = self.sample_indices(batch_size, step, warmup_steps, rng)
        rows = [self.ds.get(i, rng) for i in idxs]
        image = np.stack([r["image"] for r in rows])
        target = np.stack([r["target"] for r in rows])
        # pad to full batch by repeating (bucket exhaustion can shorten it)
        while image.shape[0] < batch_size:
            k = batch_size - image.shape[0]
            image = np.concatenate([image, image[:k]])
            target = np.concatenate([target, target[:k]])
        return {
            "image": image, "target": target,
            "valid": np.ones((batch_size,), bool),
        }
