"""Device time inside named program spans, read from one ``spans.collect``
of a ``--trace 1`` run.

``spans.read`` keeps a fixed set of readings and lets the profiled events
go; the metrics here need device time inside spans it does not read (and
inside pairs of spans). The first reader of a traced ``View`` runs
``spans.collect`` once (a ``Trainer`` built again from the cell's
configuration and the run's ``--seed``, the calls of ``spans``' docstring)
and keeps on the ``View`` every profiled device operation with its kernel
name and the chain of program spans that hold its launch (attributed as
``spans.program_ops`` attributes them), the number of ranges of each span
name, and ``spans.read``'s readings, so that no reader collects again.
Every reader returns None where the window traced no device operation,
where the program has no tracer, and where the profiled calls hold no
range of the spans it reads (a program without them).
"""
from __future__ import annotations

import torch

from . import spans


def _names(events) -> dict:
    """{(start ns, duration ns): kernel name} of the device operations."""
    return {(e.start_ns(), e.duration_ns()): e.name() for e in events
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.name().startswith(spans.RANGE_PREFIX)}


def named_ops(events) -> tuple[list, dict]:
    """The profiled device operations as (start ns, duration ns, kernel
    name, chain of span names holding the launch, innermost first; None
    where no launch matched), sorted by start, and the number of ranges of
    each span name."""
    ops, ranges = spans.program_ops(events)
    names = _names(events)
    count: dict = {}
    for _, _, name in ranges:
        count[name] = count.get(name, 0) + 1
    return [(s, d, names.get((s, d), ""), chain) for s, d, chain in ops], count


def collected(view):
    """What ``collect`` read for the cell ``view`` traced, built at the
    first call and kept on the view: {"ops", "ranges"} (``named_ops``);
    None where the window traced no device operation or the program has
    no tracer."""
    if not view.launches:
        return None
    if not hasattr(view, "op_spans"):
        tracer = spans.program_tracer()
        view.op_spans = None
        if tracer is not None:
            got = spans.collect(view.config, view.traffic, spans.run_seed(),
                                "cuda", tracer)
            ops, ranges = named_ops(got["events"])
            view.op_spans = {"ops": ops, "ranges": ranges}
            if not hasattr(view, "program_spans"):
                view.program_spans = spans.read(got)
    return view.op_spans


def device_ms(ops, *names) -> float:
    """Device ms of the operations launched inside every span named."""
    return sum(d for _, d, _, chain in ops
               if chain is not None and all(n in chain for n in names)) / 1e6


def ms_per_step(view, *names):
    """Device ms a train step launched inside every span of ``names``;
    None where the profiled steps hold none of the innermost's ranges."""
    if not view.steps:
        return None
    got = collected(view)
    if got is None:
        return None
    steps = got["ranges"].get("train.step")
    if not steps or not got["ranges"].get(names[-1]):
        return None
    return device_ms(got["ops"], *names) / steps


def attn_backward_ms(view):
    """Device ms a train step launched inside ``attention.backward``: the
    attention VJP's f32 recompute, its products and its softmax work."""
    return ms_per_step(view, "train.backward", "attention.backward")


def recompute_ms(view):
    """Device ms a train step launched inside ``model.remat`` within
    ``train.backward``: the checkpointed blocks' recompute."""
    return ms_per_step(view, "train.backward", "model.remat")


def _reading(key: str):
    """A reader of ``spans.read``'s ``key``, from this module's one
    ``collect`` (so that the cell's span metrics collect once whatever
    order they are read in)."""
    def read_metric(view):
        if collected(view) is None:
            return None
        got = getattr(view, "program_spans", None)
        return None if got is None else got.get(key)

    read_metric.__doc__ = f"``{key}`` of ``spans.read``, collected once."
    return read_metric


backward_ms = _reading("backward_ms")
host_enqueue_ms = _reading("host_enqueue_ms")
