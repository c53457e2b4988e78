"""The per-layer metrics read from the program's own spans and counters
(``dsdiff_torch.utils.profiling``), for a ``--trace 1`` run.

They come from calls of their own, made once the run is over, so that no
other reading sees them: a ``Trainer`` built again from the cell's
configuration and the run's ``--seed`` (the same weights and inputs), one
untimed call to warm it, then

- ``TRACED_CALLS`` calls with the tracer on and no ``torch.profiler``,
  each after an untraced one: the host-clock metrics and the counter (the
  profiler slows the host, so host time is not read under it), and the
  tracer's cost when on, the two calls' host seconds, logged to stderr;
- ``PROFILED_CALLS`` calls with the tracer on under ``torch.profiler``
  with CPU and CUDA activity: device time by span. Each device operation
  belongs to the program spans whose ``dsdiff/`` range, on any thread,
  holds the call that launched it (matched by correlation id); an idle gap
  belongs to the operation that ends it. The ranges' own device-side
  events (``gpu_user_annotation``) are not operations.

A call is a request (serve) or a step (train), each waited for as the
window waits for it. The metric files call this module with the traced
window's ``View``; the first builds the readings and keeps them on the
``View``. Every reader returns None where the window traced no device
operation, and where the program has no tracer (the readings then make
no call).
"""
from __future__ import annotations

import argparse
import importlib
import statistics
import sys
import time

import torch

from . import program
from .data import ServePool, TrainFeed
from .runner import log
from .seeds import sub_seed
from .trace import _LAUNCH_PREFIXES, Tracer

# (program-traced unprofiled calls, profiled calls) by the mix's kind
TRACED_CALLS = {"serve": 2, "train": 3}
PROFILED_CALLS = {"serve": 1, "train": 2}
RANGE_PREFIX = "dsdiff/"
_TRACER_API = ("span", "enable", "disable", "drain")


def program_tracer():
    """The program's tracer module, or None where it has none."""
    try:
        mod = importlib.import_module("dsdiff_torch.utils.profiling")
    except ImportError:
        return None
    return mod if all(hasattr(mod, n) for n in _TRACER_API) else None


def run_seed(argv=None) -> int:
    """The run's ``--seed`` from its command line (a reader is handed the
    ``View`` alone); 0 where there is none."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_known_args(sys.argv[1:] if argv is None else argv)[0].seed


def _serve_call(config, traffic, seed, device):
    trainer = program.build_trainer(config, sub_seed(seed, "weights"), device)
    pool = ServePool(config, traffic, seed, device)

    def call(i):
        cond, x_T = pool.request(i)
        return bool(torch.isfinite(trainer.sample_fn(cond, None, x_T)).all())

    return call


def _train_call(config, traffic, seed, device):
    trainer = program.build_trainer(config, sub_seed(seed, "weights"), device)
    feed = TrainFeed(config, traffic, seed, device)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "feed") + 1)

    def call(i):
        batch, t, noise = feed.next()
        metrics = trainer.train_step(batch, gen, t=t, noise=noise)
        return bool(torch.isfinite(metrics["loss"]))

    return call


def collect(config: dict, traffic: dict, seed: int, device, tracer) -> dict:
    """Runs the calls of the module docstring with ``tracer`` (the
    program's tracer module). Returns ``{"kind", "host": what the tracer
    drained over the unprofiled traced calls, "events": the profiled
    calls' kineto events, "untraced_s", "traced_s": each call's host
    seconds}``."""
    kind = traffic["kind"]
    make = {"serve": _serve_call, "train": _train_call}[kind]
    call = make(config, traffic, seed, device)
    call(0)
    i, untraced_s, traced_s = 1, [], []
    tracer.disable()
    tracer.drain()
    try:
        for _ in range(TRACED_CALLS[kind]):
            for on, times in ((False, untraced_s), (True, traced_s)):
                if on:
                    tracer.enable()
                t = time.perf_counter()
                call(i)
                times.append(time.perf_counter() - t)
                tracer.disable()
                i += 1
        host = tracer.drain()
        prof = Tracer(device, host=True)
        tracer.enable()
        prof.start()
        for _ in range(PROFILED_CALLS[kind]):
            call(i)
            i += 1
        prof.stop()
    finally:
        tracer.disable()
        tracer.drain()
    log(f"program spans: host s a {kind} call, untraced "
        f"{[round(s, 4) for s in untraced_s]}, traced "
        f"{[round(s, 4) for s in traced_s]}")
    return {"kind": kind, "host": host, "events": prof.events(),
            "untraced_s": untraced_s, "traced_s": traced_s}


def program_ops(events):
    """The profiled calls' device operations, each as (start ns, duration
    ns, the names of the program spans that hold its launch, innermost
    first; None where no launch call matched), sorted by start, and the
    spans' ranges as (start ns, end ns, name)."""
    ranges, launches, ops = [], {}, []
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not name.startswith(RANGE_PREFIX):
                ops.append((e.start_ns(), e.duration_ns(), e.correlation_id()))
        elif name.startswith(RANGE_PREFIX):
            ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                           name[len(RANGE_PREFIX):]))
        elif name.startswith(_LAUNCH_PREFIXES):
            launches[e.correlation_id()] = e.start_ns()
    ranges.sort()
    at = sorted((launches[c], k) for k, (_, _, c) in enumerate(ops)
                if c in launches)
    chains = [None] * len(ops)
    active, r = [], 0
    for t, k in at:
        while r < len(ranges) and ranges[r][0] <= t:
            active.append(ranges[r])
            r += 1
        active = [a for a in active if a[1] >= t]
        chains[k] = tuple(a[2] for a in sorted(active,
                                               key=lambda a: a[1] - a[0]))
    out = sorted((s, d, chains[k]) for k, (s, d, _) in enumerate(ops))
    return out, ranges


def _device_ms(ops, *names) -> float:
    """Device ms of the operations launched inside every span named."""
    return sum(d for _, d, chain in ops
               if chain is not None and all(n in chain for n in names)) / 1e6


def _idle_outside_ms(ops, name) -> float:
    """Idle ms in the gaps between operations that end at an operation
    launched outside every span ``name``."""
    total, end = 0, None
    for s, d, chain in ops:
        if end is not None and s > end and chain is not None \
                and name not in chain:
            total += s - end
        end = s + d if end is None else max(end, s + d)
    return total / 1e6


def _median_ms(spans, name):
    ms = [r.ms for r in spans if r.name == name]
    return statistics.median(ms) if ms else None


def read(collected: dict) -> dict:
    """The metrics of one ``collect``: for serve ``host_enqueue_ms`` (median
    host ms of a ``model.forward``), ``found_idle`` (% of model calls whose
    entry found the card with nothing queued), ``encoders_ms`` (device ms
    a model call launched inside ``model.encoders``) and
    ``outside_model_idle_ms`` (idle device ms a request in gaps ended by an
    operation launched outside every ``model.forward``); for train
    ``host_enqueue_ms`` (median host ms of a ``train.step``),
    ``backward_ms`` (device ms a step launched while ``train.backward`` was
    open) and ``recompute_ms`` (of those, inside ``model.remat``). A
    metric with nothing to read is left out."""
    spans = collected["host"]["spans"]
    ops, ranges = program_ops(collected["events"])
    n = {}
    for _, _, name in ranges:
        n[name] = n.get(name, 0) + 1
    out = {}
    if collected["kind"] == "serve":
        out["host_enqueue_ms"] = _median_ms(spans, "model.forward")
        calls = [r for r in spans if r.name == "model.forward"]
        if calls:
            idle = sum(1 for r in calls if r.counts.get("model.found_idle"))
            out["found_idle"] = 100.0 * idle / len(calls)
        if ops and n.get("model.forward") and n.get("model.encoders"):
            out["encoders_ms"] = (_device_ms(ops, "model.encoders")
                                  / n["model.forward"])
        if ops and n.get("serve.request"):
            out["outside_model_idle_ms"] = (
                _idle_outside_ms(ops, "model.forward") / n["serve.request"])
    else:
        out["host_enqueue_ms"] = _median_ms(spans, "train.step")
        steps = n.get("train.step")
        if ops and steps and n.get("train.backward"):
            out["backward_ms"] = _device_ms(ops, "train.backward") / steps
            if n.get("model.remat"):
                out["recompute_ms"] = _device_ms(ops, "train.backward",
                                                 "model.remat") / steps
    return {k: v for k, v in out.items() if v is not None}


def readings(view):
    """The metrics of ``read`` for the cell ``view`` traced, built at the
    first call and kept on the view; None where the window traced no
    device operation or the program has no tracer."""
    if not view.launches:
        return None
    if not hasattr(view, "program_spans"):
        tracer = program_tracer()
        view.program_spans = None if tracer is None else read(collect(
            view.config, view.traffic, run_seed(), "cuda", tracer))
    return view.program_spans


def _reader(key: str):
    def read_metric(view):
        got = readings(view)
        return None if got is None else got.get(key)

    read_metric.__doc__ = f"``{key}`` of ``readings``."
    return read_metric


host_enqueue_ms = _reader("host_enqueue_ms")
found_idle = _reader("found_idle")
encoders_ms = _reader("encoders_ms")
outside_model_idle_ms = _reader("outside_model_idle_ms")
backward_ms = _reader("backward_ms")
recompute_ms = _reader("recompute_ms")
