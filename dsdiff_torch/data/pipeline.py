"""Slice dataset + deterministic prefetching batch loader.

Port of the JAX package's ``data/pipeline.py``: the same rows and the same
batches, array for array. It replaces the MONAI Compose/DataLoader stack
(trainers/trainer_use_gaussian_diff.py:148-171, 377-388) with a plain-numpy
pipeline:

- examples are (case, slice) pairs resolved from the H5 store contract,
- the transform chain (LoadH5 -> pad-to-/32 -> concat conditions -> optional
  edge channel -> rotate/flip) mirrors get_2d_train_transform_diff
  (training_transform.py:220-296) but emits NHWC float32,
- ``train_keys`` semantics are the reference's: conditions = keys[:-1]
  concatenated into "image", ground truth = keys[-1]
  (trainer_use_gaussian_diff.py:446-466),
- randomness flows from one integer seed -> per-(epoch, index)
  np.random.Generator, so any batch is reproducible on any host,
- a background thread prefetches the next batch while the device steps
  (host/device overlap without torch worker processes); ``build_seconds``
  records the host time it spent on each batch of the last epoch.
"""
from __future__ import annotations

import queue
import threading
import time
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from ..parallel import dist as pdist
from . import h5store, transforms

__all__ = ["SliceDataset", "BatchLoader"]


class SliceDataset:
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
        self.pad_to = pad_to
        if cases is None:
            cases = h5store.list_cases(self.split_dir)
        self.cases = list(cases)
        self.examples = []
        for case in self.cases:
            for p in h5store.case_slices(self.split_dir / case):
                self.examples.append((case, h5store.slice_index(p), p))
        if not self.examples:
            raise ValueError(f"no slices found under {self.split_dir}")

    def __len__(self) -> int:
        return len(self.examples)

    def image_channels(self) -> int:
        return len(self.keys) - 1 + (1 if self.use_edge else 0)

    def get(self, i: int, rng: np.random.Generator) -> dict:
        case, sidx, path = self.examples[i]
        raw = h5store.read_slice(path, self.keys)
        chans = [
            transforms.divisible_pad(
                np.asarray(raw[k], dtype=np.float32), self.pad_to
            )
            for k in self.keys
        ]
        cond = np.stack(chans[:-1])  # [C, H, W]
        target = chans[-1][None]  # [1, H, W]
        if self.use_edge:
            edge = transforms.edge_map(cond, kind=str(self.use_edge), rng=rng)
            cond = np.concatenate([cond, edge], axis=0)
        if self.augment:
            cond, target = transforms.random_rotate(
                [cond, target], rng, prob=self.aug_prob
            )
            cond, target = transforms.random_flip(
                [cond, target], rng, prob=self.aug_prob
            )
        return {
            "image": cond.transpose(1, 2, 0).astype(np.float32),  # HWC
            "target": target.transpose(1, 2, 0).astype(np.float32),
            "case": case,
            "slice": sidx,
        }


class BatchLoader:
    """Deterministic shuffling + background-prefetch batching.

    For ``drop_last=False`` the final short batch is zero-padded to full size
    and a boolean ``valid`` mask marks real rows (variable slice counts per
    case at predict time — SURVEY.md §7 risk item).

    ``batch_size`` is GLOBAL. With ``process_count`` > 1 every process
    computes the identical global index order but materializes only its
    contiguous ``batch_size/process_count`` rows (from ``process_index``) of
    each batch, the reference's DistributedSampler
    (trainers/trainer_ds_diff.py:268-311). Both default to the process
    group's (``parallel.dist``): one process and index 0 without one.
    """

    def __init__(
        self,
        dataset: SliceDataset,
        batch_size: int,
        seed: int = 0,
        shuffle: bool = True,
        drop_last: bool = True,
        prefetch: int = 2,
        process_count: int | None = None,
        process_index: int | None = None,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        if process_count is None:
            process_count = pdist.process_count()
        if process_index is None:
            process_index = pdist.process_index()
        self.process_count = int(process_count)
        self.process_index = int(process_index)
        if batch_size % self.process_count:
            raise ValueError(
                f"global batch_size {batch_size} not divisible by "
                f"process_count {self.process_count}"
            )
        self.local_batch_size = batch_size // self.process_count
        self.build_seconds: list[float] = []

    def __len__(self) -> int:
        n = len(self.ds)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_order(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        return idx

    def _make_batch(self, epoch: int, batch_idx: int, idxs) -> dict:
        # materialize only this process's contiguous slice of the global
        # batch; rows beyond the dataset tail (drop_last=False padding)
        # arrive as -1 and become zero-padded invalid rows
        lo = self.process_index * self.local_batch_size
        idxs = [int(i) for i in idxs[lo : lo + self.local_batch_size]
                if int(i) >= 0]
        rows = []
        for i in idxs:
            rng = np.random.default_rng(
                np.random.SeedSequence(
                    [self.seed, epoch, int(i)]
                )
            )
            rows.append(self.ds.get(int(i), rng))
        B = self.local_batch_size
        n = len(rows)
        if rows:
            image = np.stack([r["image"] for r in rows])
            target = np.stack([r["target"] for r in rows])
            self._shapes = (image.shape[1:], target.shape[1:])
        else:
            if not hasattr(self, "_shapes"):
                probe = self.ds.get(0, np.random.default_rng(0))
                self._shapes = (probe["image"].shape, probe["target"].shape)
            image = np.zeros((0,) + self._shapes[0], np.float32)
            target = np.zeros((0,) + self._shapes[1], np.float32)
        valid = np.ones((n,), dtype=bool)
        if n < B:
            pad = B - n
            image = np.concatenate([image, np.zeros((pad,) + image.shape[1:],
                                                    image.dtype)])
            target = np.concatenate([target,
                                     np.zeros((pad,) + target.shape[1:],
                                              target.dtype)])
            valid = np.concatenate([valid, np.zeros((pad,), bool)])
        return {
            "image": image,
            "target": target,
            "valid": valid,
            "case": [r["case"] for r in rows],
            "slice": [r["slice"] for r in rows],
        }

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        order = self._index_order(epoch)
        nb = len(self)
        # pad the global order to whole batches with -1 sentinels so every
        # process sees identically-sized global batches (short-tail rows
        # become invalid zero rows)
        need = nb * self.batch_size
        if order.size < need:
            order = np.concatenate(
                [order, np.full(need - order.size, -1, order.dtype)]
            )
        batches = [
            order[b * self.batch_size : (b + 1) * self.batch_size]
            for b in range(nb)
        ]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        seconds = self.build_seconds = []

        def worker():
            try:
                for b, idxs in enumerate(batches):
                    if stop.is_set():
                        return
                    t0 = time.perf_counter()
                    batch = self._make_batch(epoch, b, idxs)
                    seconds.append(time.perf_counter() - t0)
                    q.put(batch)
                q.put(None)
            except BaseException as e:  # propagate to the consumer
                q.put(e)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the worker can exit
            while th.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            th.join(timeout=5)
