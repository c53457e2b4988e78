"""The port's tracer, step timers, device traces and FLOP counts.

The tracer: ``span(name, **attrs)`` marks one layer boundary of the program
and ``count(name, n)`` one event inside it. Both do nothing until
``enable()``: off, a span is one module-level flag check that returns a
shared no-op context, reading no clock and allocating no record. On, a span
records its name, its id, its parent's id, the id of the request or step at
its root, its attributes, its host start and end (``time.perf_counter_ns``)
and the counters that fired inside it; the records wait in a bounded
buffer until ``drain()`` hands them over. While a ``torch.profiler`` is
recording, each span also opens ``record_function("dsdiff/" + name)``, so
that the spans lie in the profiler's event list, on its clock, beside the
kernels and the calls that launched them. The tracer never waits for the
card. Spans opened on another thread (the autograd engine's, which runs a
backward and the checkpoint recompute inside it on a card) nest under the
innermost span open on the thread of the current root; a reader of the
profiler's events places them by time, not by thread.

The program's spans and counters, and what reads each:

- ``serve.request`` (root; ``batch``, ``steps``): ``Trainer.sample_fn``;
- ``model.forward``: every denoiser call of a sampler and the train
  objective's model call (host dispatch a model call); its entry counts
  ``model.found_idle`` where the card had finished all that was queued;
- ``model.encoders``: DSUNet's and DiscUNet's encoding of all streams;
- ``model.remat``: a checkpointed ResBlock, opened again by its recompute;
- ``train.step`` (root): ``Trainer.train_step``; ``train.backward``: the
  step's ``loss.backward()``;
- ``fit.batch_wait`` and ``fit.to_device``: ``Trainer.fit`` taking its next
  batch and moving it to the card (``fit``'s log reads their host totals).

Besides: ``StepTimer`` (steps per second, the card synchronised on read),
``profile_scope`` and ``scope_totals`` (a span, and the host seconds spent
in each span name), ``trace`` (a ``torch.profiler`` capture with the spans
on, whose chrome trace is written into ``log_dir``), ``compiled_flops``
(the FLOPs of one call counted by ``torch.utils.flop_counter``: 2·M·N·K for
a matmul, as XLA's cost analysis counts) and ``steps_per_sec_per_chip``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from collections import defaultdict, deque
from pathlib import Path

import torch

from .device import resolve_device

__all__ = ["span", "count", "count_idle", "enable", "disable", "enabled",
           "drain", "SpanRecord", "StepTimer", "profile_scope",
           "scope_totals", "trace", "compiled_flops",
           "steps_per_sec_per_chip"]

# the finished spans kept for ``drain``; the oldest go first beyond this
SPAN_BUFFER = 65536
RANGE_PREFIX = "dsdiff/"

_on = False
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_spans: deque = deque(maxlen=SPAN_BUFFER)
_counts: dict = defaultdict(int)
_host_ns: dict = defaultdict(int)
# the span stack of the thread whose root span is open, or None
_root_stack = None


@dataclasses.dataclass
class SpanRecord:
    """One finished span; ``t0_ns`` / ``t1_ns`` on ``perf_counter_ns``."""

    name: str
    id: int
    parent: int | None
    root: int
    attrs: dict
    t0_ns: int = 0
    t1_ns: int = 0
    counts: dict = dataclasses.field(default_factory=dict)

    @property
    def ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6


# every span while the tracer is off
_OFF = contextlib.nullcontext()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("rec", "range", "stack", "is_root")

    def __init__(self, name: str, attrs: dict):
        self.rec = SpanRecord(name, next(_ids), None, 0, attrs)

    def __enter__(self) -> SpanRecord:
        global _root_stack
        rec = self.rec
        stack = self.stack = _stack()
        with _lock:
            outer = stack or _root_stack
            self.is_root = not outer
            if outer:
                rec.parent, rec.root = outer[-1].id, outer[0].root
            else:
                rec.root = rec.id
                _root_stack = stack
            stack.append(rec)
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(
                RANGE_PREFIX + rec.name)
            self.range.__enter__()
        rec.t0_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        global _root_stack
        rec = self.rec
        rec.t1_ns = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        with _lock:
            self.stack.pop()
            if self.is_root:
                _root_stack = None
            _host_ns[rec.name] += rec.t1_ns - rec.t0_ns
            _spans.append(rec)
        return False


def span(name: str, **attrs):
    """A context for one layer boundary named ``name``; a no-op unless the
    tracer is on. On, ``with span(...) as rec`` gives the ``SpanRecord``
    (None when off)."""
    if not _on:
        return _OFF
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to counter ``name``, in the innermost span open on this
    thread and in the process total (while the tracer is on)."""
    if not _on:
        return
    stack = _stack()
    with _lock:
        _counts[name] += n
        if stack:
            counts = stack[-1].counts
            counts[name] = counts.get(name, 0) + n


def count_idle(name: str, x: torch.Tensor) -> None:
    """Counts ``name`` once where ``x`` lives on a card whose current stream
    has finished all that was queued (``Stream.query``, which does not
    wait); while the tracer is on."""
    if _on and x.is_cuda and torch.cuda.current_stream(x.device).query():
        count(name)


def enable() -> None:
    """Turns the tracer on."""
    global _on
    _on = True


def disable() -> None:
    """Turns the tracer off; what it recorded stays until ``drain``."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def drain() -> dict:
    """``{"spans": [SpanRecord, ...] in the order they closed, "counts":
    {name: total}}`` recorded since the last drain, which this clears."""
    with _lock:
        spans = list(_spans)
        _spans.clear()
        counts = dict(_counts)
        _counts.clear()
    return {"spans": spans, "counts": counts}


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


def profile_scope(name: str):
    """A span named ``name`` (``span``), timed into ``scope_totals``."""
    return span(name)


def scope_totals() -> dict:
    """Host seconds spent in each span name while the tracer was on, over
    the life of the process (``drain`` leaves them)."""
    with _lock:
        return {k: ns / 1e9 for k, ns in _host_ns.items()}


@contextlib.contextmanager
def trace(log_dir, device=None):
    """Profile the block (CPU and, on a card, CUDA activity) with the
    tracer on, so that the program's spans appear as ``dsdiff/`` ranges,
    and write its chrome trace to ``log_dir/trace.json``; yields the
    profiler."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    was_on = _on
    enable()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    finally:
        if not was_on:
            disable()
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
