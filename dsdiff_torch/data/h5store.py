"""Per-slice HDF5 store + case listing + deterministic splits.

The port's own copy of the JAX package's ``data/h5store.py``. ``h5py`` is
imported inside ``write_slice`` and ``read_slice`` only, so the rest of the
port imports where it is not installed.

Directory contract matches the reference exactly
(trainers/trainer_ds_diff.py:119-122, preprocess/to_h5.py:27-51):

    <root>/images_tr_256/<case>/layer_<i>.h5     train slices
    <root>/images_ts_256/<case>/layer_<i>.h5     test slices

with datasets named by sequence key (F_Data1/F_Data2/S_Data1/S_Data2 for the
prostate task; t1/t2/t1ce/flair for BraTS). Splitting is seed-fixed K-fold at
the patient level (trainer_ds_diff.py:212-232 uses sklearn KFold with a fixed
seed so every data-parallel worker derives identical splits).
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Sequence

import numpy as np

__all__ = [
    "write_slice",
    "read_slice",
    "list_cases",
    "case_slices",
    "kfold_split",
    "train_test_split_cases",
]

_LAYER_RE = re.compile(r"layer_(\d+)\.h5$")


def write_slice(path, arrays: dict):
    """Write one slice file with one dataset per sequence key."""
    import h5py

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        for k, v in arrays.items():
            f.create_dataset(k, data=np.asarray(v))


def read_slice(path, keys: Sequence[str]) -> dict:
    """LoadH5 parity (training_project/utils/my_transform.py:142-153)."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        for k in keys:
            out[k] = f[k][()]
    return out


def list_cases(split_dir) -> list:
    """Sorted case directories under images_tr_256/ or images_ts_256/."""
    split_dir = Path(split_dir)
    if not split_dir.is_dir():
        return []
    return sorted(d.name for d in split_dir.iterdir() if d.is_dir())


def case_slices(case_dir) -> list:
    """layer_<i>.h5 paths sorted by slice index."""
    case_dir = Path(case_dir)
    files = []
    for p in case_dir.iterdir():
        m = _LAYER_RE.search(p.name)
        if m:
            files.append((int(m.group(1)), p))
    return [p for _, p in sorted(files)]


def slice_index(path) -> int:
    m = _LAYER_RE.search(str(path))
    if not m:
        raise ValueError(f"not a layer file: {path}")
    return int(m.group(1))


def kfold_split(cases: Sequence[str], n_folds: int, fold: int,
                seed: int = 42):
    """Deterministic patient-level K-fold (trainer_ds_diff.py:212-232).

    Returns (train_cases, val_cases). Same seed -> identical folds on every
    host/process.
    """
    cases = sorted(cases)
    idx = np.arange(len(cases))
    rng = np.random.RandomState(seed)
    rng.shuffle(idx)
    folds = np.array_split(idx, n_folds)
    val_idx = set(folds[fold].tolist())
    train = [cases[i] for i in idx if i not in val_idx]
    val = [cases[i] for i in sorted(val_idx)]
    return train, val


def train_test_split_cases(cases: Sequence[str], test_frac: float = 0.3,
                           seed: int = 42, record_path=None):
    """70/30 patient-level split (preprocess/spilt_train_test.py:79-101),
    persisted to CSV (the reference writes train_test.xlsx; openpyxl is not
    available here, CSV carries the same record)."""
    cases = sorted(cases)
    rng = np.random.RandomState(seed)
    idx = np.arange(len(cases))
    rng.shuffle(idx)
    n_test = int(round(len(cases) * test_frac))
    test = sorted(cases[i] for i in idx[:n_test])
    train = sorted(cases[i] for i in idx[n_test:])
    if record_path is not None:
        import csv

        record_path = Path(record_path)
        record_path.parent.mkdir(parents=True, exist_ok=True)
        with open(record_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["case", "split"])
            for c in train:
                w.writerow([c, "train"])
            for c in test:
                w.writerow([c, "test"])
    return train, test
