"""Checkpoints with best-by-val-SSIM retention and resume, torch-native.

Port of the JAX package's ``train/checkpoints.py`` (Orbax there). Each step
is one directory, ``<directory>/<step>/``, holding

- ``state.pt``: the train state as ``TrainState.state_dict`` gives it: f32
  master parameters, f32 EMA, AdamW moments, optax's update ``count``, the
  step counter and, when accumulating, the gradient accumulator and its
  ``mini_step``, every tensor on the CPU;
- ``sampler.pt``: the schedule sampler's ``loss_history`` / ``loss_counts``;
- ``metrics.json``: the metrics the step was saved with.

A step is written under ``<step>.tmp`` and renamed when complete, so a
directory named by a step number is whole. Files are read with
``torch.load(weights_only=True)``. Retention is the JAX package's: the best
``max_to_keep`` by ``val_ssim`` plus always the latest, which is the resume
anchor. A checkpoint written by the other encoder stream layout (stacked
``encoders`` vs sequential ``encoder_{i}``) is converted through
``train.surgery.convert_stream_layout`` on restore.

In a process group (a trainer under a mesh), every rank calls ``save``,
which gathers a sharded state whole; rank 0 writes the step and prunes,
then every rank waits for it. ``restore`` on every rank reads the same
files and ``TrainState.load`` keeps the rank's shards, so a checkpoint
written by any number of ranks restores in any other number.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import torch

from ..parallel import dist as pdist
from . import schedule_sampler as ss
from .state import TrainState
from .surgery import convert_stream_layout

__all__ = ["CheckpointManager"]

_TENSOR_GROUPS = ("params", "ema", "mu", "nu", "acc")


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for name, value in flat.items():
        *mods, leaf = name.split(".")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = value
    return tree


def _unnest(tree, prefix: str = "") -> dict:
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_unnest(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _match_layout(names, flat: dict) -> dict:
    """``flat`` ({parameter name: tensor}) keyed by ``names``, converting
    the encoder stream layout if that is what separates them."""
    if set(flat) == set(names):
        return flat
    converted = {k: torch.as_tensor(np.asarray(v)) for k, v in
                 _unnest(convert_stream_layout(_nest(flat))).items()}
    missing = sorted(set(names) - set(converted))
    if missing:
        raise ValueError(
            "checkpoint layout does not match the model even after "
            f"stream-layout conversion (missing {missing[:4]}); check "
            "stream_mode / architecture"
        )
    return {n: converted[n] for n in names}


class CheckpointManager:
    def __init__(self, directory, max_to_keep: int = 3,
                 best_metric: str = "val_ssim", keep_best: bool = True):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = int(max_to_keep)
        self.best_metric = best_metric
        self.keep_best = keep_best

    # ----------------------------------------------------------- discovery
    def all_steps(self) -> list[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _metric(self, step: int) -> float:
        path = self.directory / str(step) / "metrics.json"
        metrics = json.loads(path.read_text()) if path.exists() else {}
        return float(metrics.get(self.best_metric, -1.0))

    def _ranked(self) -> list[int]:
        """Steps, best metric first (the newer of equals first)."""
        return sorted(self.all_steps(), key=lambda s: (self._metric(s), s),
                      reverse=True)

    def best_step(self) -> int | None:
        if not self.keep_best:
            return None
        ranked = self._ranked()
        return ranked[0] if ranked else None

    # ---------------------------------------------------------------- save
    def save(self, step: int, state: TrainState,
             sampler_state: ss.SamplerState | None = None,
             metrics: dict | None = None) -> Path:
        final = self.directory / str(int(step))
        full = state.state_dict()  # every rank: gathers a sharded state
        if not pdist.is_main():
            pdist.sync_hosts()
            return final
        tmp = self.directory / f"{int(step)}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        payload = {}
        for key, value in full.items():
            payload[key] = ({n: t.detach().cpu() for n, t in value.items()}
                            if isinstance(value, dict) else value)
        torch.save(payload, tmp / "state.pt")
        if sampler_state is not None:
            torch.save({"kind": sampler_state.kind,
                        "loss_history": sampler_state.loss_history.cpu(),
                        "loss_counts": sampler_state.loss_counts.cpu()},
                       tmp / "sampler.pt")
        (tmp / "metrics.json").write_text(json.dumps(
            {k: float(v) for k, v in (metrics or {}).items()}))
        shutil.rmtree(final, ignore_errors=True)
        tmp.rename(final)
        self._prune()
        pdist.sync_hosts()
        return final

    def _prune(self) -> None:
        steps = self.all_steps()
        if self.keep_best:
            keep = set(self._ranked()[: self.max_to_keep]) | {steps[-1]}
        else:
            keep = set(steps[-self.max_to_keep:])
        for s in steps:
            if s not in keep:
                shutil.rmtree(self.directory / str(s))

    # ------------------------------------------------------------- restore
    def _load(self, step: int, name: str) -> dict:
        return torch.load(self.directory / str(step) / name,
                          map_location="cpu", weights_only=True)

    def restore(self, state: TrainState,
                sampler_state: ss.SamplerState | None = None,
                step: int | None = None):
        """Load checkpoint ``step`` (default the latest) into ``state`` in
        place; returns (state, sampler_state), the sampler's buffers
        replaced when they were saved. Without checkpoints, returns both
        unchanged."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return state, sampler_state
        saved = self._load(step, "state.pt")
        groups = {k: _match_layout(state.names, saved[k])
                  for k in _TENSOR_GROUPS if k in saved}
        state.load(**groups, count=saved["count"], step=saved["step"],
                   mini_step=saved.get("mini_step", 0))
        sampler_path = self.directory / str(step) / "sampler.pt"
        if sampler_state is not None and sampler_path.exists():
            buf = self._load(step, "sampler.pt")
            dev = sampler_state.loss_history.device
            sampler_state = ss.SamplerState(
                buf["kind"], buf["loss_history"].to(dev),
                buf["loss_counts"].to(dev))
        return state, sampler_state

    def restore_params(self, model: torch.nn.Module, step: int | None = None,
                       ema: bool = True) -> dict:
        """The EMA (or raw) parameters of checkpoint ``step`` (default the
        best, else the latest) as a state dict for ``model``, on its device
        and in its parameters' dtypes."""
        if step is None:
            step = self.best_step() or self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        saved = self._load(step, "state.pt")["ema" if ema else "params"]
        params = dict(model.named_parameters())
        flat = _match_layout(list(params), saved)
        return {n: flat[n].to(p.device, p.dtype) for n, p in params.items()}
