"""Profiling: step timers, accumulated scopes, device traces, FLOP counts.

Port of the JAX package's ``utils/profiling.py``: ``StepTimer`` (steps per
second, the card synchronised on read), ``profile_scope`` (a
``torch.profiler.record_function`` range that also accumulates its wall
time, read by ``scope_totals``), ``trace`` (a ``torch.profiler`` capture
whose chrome trace is written into ``log_dir``), ``compiled_flops`` (the
FLOPs of one call counted by ``torch.utils.flop_counter``: 2·M·N·K for a
matmul, as XLA's cost analysis counts) and ``steps_per_sec_per_chip``.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import torch

from .device import resolve_device

__all__ = ["StepTimer", "profile_scope", "scope_totals", "trace",
           "compiled_flops", "steps_per_sec_per_chip"]

_scopes: dict = defaultdict(float)


class StepTimer:
    """Rolling steps per second on ``device`` (default ``"cuda"``), whose
    queued work ``rate`` waits for."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n: int = 1) -> None:
        self._steps += n

    def rate(self) -> float:
        """Steps per second since ``reset``, after the card has finished
        what was queued."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else 0.0


@contextlib.contextmanager
def profile_scope(name: str):
    """A named range in profiler traces whose wall time accumulates under
    ``name`` (``scope_totals``)."""
    with torch.profiler.record_function(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _scopes[name] += time.perf_counter() - t0


def scope_totals() -> dict:
    """Seconds spent in each ``profile_scope`` name so far."""
    return dict(_scopes)


@contextlib.contextmanager
def trace(log_dir, device=None):
    """Profile the block (CPU and, on a card, CUDA activity) and write its
    chrome trace to ``log_dir/trace.json``; yields the profiler."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(str(out / "trace.json"))


def compiled_flops(fn, *args, **kwargs) -> float:
    """The FLOPs of one call ``fn(*args, **kwargs)``, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (runs the call once, with
    no gradient)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def steps_per_sec_per_chip(step_time_s: float, n_chips: int = 1) -> float:
    return 1.0 / (step_time_s * n_chips) if step_time_s > 0 else 0.0
