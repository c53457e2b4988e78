"""Memory-mapped npy volume datasets, numpy only.

Port of the JAX package's ``data/npy_dataset.py`` (DisC-Diff data plane,
Disc_diff/guided_diffusion/image_datasets.py):

- ``NpyVolumeDataset``: stacked [N, H, W] npy arrays per sequence,
  memory-mapped (BraTSMRI :59-92, incl. the central-slice window option),
  returning the rows of ``pipeline.SliceDataset``: the same transform chain
  (pad to /32, the optional edge channel, rotate, flip) in the same order
  of random draws, and the ``case`` / ``slice`` that ``Trainer.predict``
  assembles volumes from.
- ``NpyCaseDataset``: a case store laid out as the H5 store, one stack per
  case and sequence key, ``<root>/images_{tr,ts}_<size>/<case>/<key>.npy``
  ([S, H, W], row s is ``layer_<s>``). Same constructor and rows as
  ``SliceDataset``; the trainer reads it with ``data_store: npy``.
- ``build_volume_cache``: H5 slice store -> stacked npy per sequence
  (training_project/utils/create_whole_dataset.py); reading H5 needs
  ``h5py``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from . import h5store
from .transforms import divisible_pad, edge_map, random_flip, random_rotate

__all__ = ["NpyVolumeDataset", "NpyCaseDataset", "write_case",
           "build_volume_cache"]


class NpyVolumeDataset:
    """``npy_paths``: {sequence key: path of an [N, H, W] stack}. The
    conditions are ``cond_keys`` in order (default: every key but
    ``gt_key``, in ``npy_paths`` order); rows carry ``case``."""

    def __init__(
        self,
        npy_paths: dict,
        gt_key: str,
        slice_range: tuple | None = None,
        augment: bool = False,
        aug_prob: float = 0.5,
        pad_to: int = 32,
        cond_keys: Sequence[str] | None = None,
        use_edge: str | bool = False,
        case: str = "npy",
    ):
        self.arrays = {k: np.load(p, mmap_mode="r")
                       for k, p in npy_paths.items()}
        shapes = {a.shape for a in self.arrays.values()}
        if len(shapes) != 1:
            raise ValueError(f"misaligned npy stacks: {shapes}")
        self.gt_key = gt_key
        self.cond_keys = (list(cond_keys) if cond_keys is not None
                          else [k for k in self.arrays if k != gt_key])
        n = next(iter(shapes))[0]
        if slice_range is not None:
            lo, hi = slice_range
            self.index = list(range(lo, min(hi, n)))
        else:
            self.index = list(range(n))
        self.augment = augment
        self.aug_prob = aug_prob
        self.pad_to = pad_to
        self.use_edge = use_edge
        self.case = case

    def __len__(self):
        return len(self.index)

    def get(self, i: int, rng: np.random.Generator) -> dict:
        s = self.index[i]
        cond = np.stack([
            divisible_pad(np.asarray(self.arrays[k][s], np.float32),
                          self.pad_to)
            for k in self.cond_keys
        ])
        target = divisible_pad(
            np.asarray(self.arrays[self.gt_key][s], np.float32), self.pad_to
        )[None]
        if self.use_edge:
            edge = edge_map(cond, kind=str(self.use_edge), rng=rng)
            cond = np.concatenate([cond, edge], axis=0)
        if self.augment:
            cond, target = random_rotate([cond, target], rng,
                                         prob=self.aug_prob)
            cond, target = random_flip([cond, target], rng,
                                       prob=self.aug_prob)
        return {
            "image": cond.transpose(1, 2, 0).astype(np.float32),
            "target": target.transpose(1, 2, 0).astype(np.float32),
            "case": self.case, "slice": s,
        }

    def image_channels(self) -> int:
        return len(self.cond_keys) + (1 if self.use_edge else 0)


class NpyCaseDataset:
    """The npy case store under ``root/split``, with ``SliceDataset``'s
    constructor: conditions ``keys[:-1]``, ground truth ``keys[-1]``."""

    def __init__(
        self,
        root,
        split: str = "images_tr_256",
        cases: Sequence[str] | None = None,
        keys: Sequence[str] = ("F_Data1", "F_Data2", "S_Data1", "S_Data2"),
        use_edge: str | bool = False,
        augment: bool = False,
        aug_prob: float = 0.5,
        pad_to: int = 32,
    ):
        self.root = Path(root)
        self.split_dir = self.root / split
        self.keys = list(keys)
        self.use_edge = use_edge
        self.augment = augment
        self.aug_prob = aug_prob
        if cases is None:
            cases = h5store.list_cases(self.split_dir)
        self.cases = list(cases)
        self.volumes = [
            NpyVolumeDataset(
                {k: self.split_dir / case / f"{k}.npy" for k in self.keys},
                gt_key=self.keys[-1], cond_keys=self.keys[:-1],
                augment=augment, aug_prob=aug_prob, pad_to=pad_to,
                use_edge=use_edge, case=case,
            )
            for case in self.cases
        ]
        self.examples = [(v, j) for v, vol in enumerate(self.volumes)
                         for j in range(len(vol))]
        if not self.examples:
            raise ValueError(f"no slices found under {self.split_dir}")

    def __len__(self) -> int:
        return len(self.examples)

    def image_channels(self) -> int:
        return len(self.keys) - 1 + (1 if self.use_edge else 0)

    def get(self, i: int, rng: np.random.Generator) -> dict:
        v, j = self.examples[i]
        return self.volumes[v].get(j, rng)


def write_case(case_dir, slices: Sequence[dict]) -> None:
    """Write one case of the npy store: ``slices`` is one {key: [H, W]}
    dict per slice, in slice order."""
    case_dir = Path(case_dir)
    case_dir.mkdir(parents=True, exist_ok=True)
    for k in slices[0]:
        np.save(case_dir / f"{k}.npy",
                np.stack([np.asarray(s[k], np.float32) for s in slices]))


def build_volume_cache(h5_root, split: str, keys: Sequence[str], out_dir):
    """H5 slice store -> one stacked [N, H, W] npy per sequence key
    (create_whole_dataset.py parity)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    stacks: dict[str, list] = {k: [] for k in keys}
    for case in h5store.list_cases(Path(h5_root) / split):
        for p in h5store.case_slices(Path(h5_root) / split / case):
            row = h5store.read_slice(p, keys)
            for k in keys:
                stacks[k].append(np.asarray(row[k], np.float32))
    paths = {}
    for k in keys:
        arr = np.stack(stacks[k])
        path = out_dir / f"{k}.npy"
        np.save(path, arr)
        paths[k] = path
    return paths
