"""The traced sub-window of a ``--trace 1`` run and what its readers see.

``Tracer`` runs ``torch.profiler`` (no shapes, no stacks, nothing written
to disk) over a few whole calls of the window, synchronised at both ends:
the device's activity alone for the per-layer metrics, and the host's ops
too over a call after them, to name the idle gaps. ``View`` holds what was
read from the trace:
every device operation (kernels, copies, fills) with its start and length,
device time by kernel family (``families``), the busy time (the union of
the device intervals), the traced window's length on the host clock, the
idle gaps between device operations, each named by the outermost host op
that launched the operation after it, the counts of the calls traced, and
the host seconds that an untraced call of the same window took (the
profiler slows the host, so a share of the wall time is read against it).
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from .families import family

# host-side events that launch device work (CUDA runtime and driver calls)
_LAUNCH_PREFIXES = ("cuda", "cu")


class Tracer:
    """``torch.profiler`` over a span of calls: the device's activity, and
    with ``host`` the host's ops too (which slows the host)."""

    def __init__(self, device, host: bool):
        self.device = torch.device(device)
        self.host = host
        self.prof = None
        self.t0 = self.t1 = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def start(self) -> None:
        acts = []
        if self.host or self.device.type != "cuda":
            acts.append(ProfilerActivity.CPU)
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts, record_shapes=False,
                            with_stack=False)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def events(self):
        return self.prof.profiler.kineto_results.events()


class View:
    """The traced window as the per-layer readers take it."""

    def __init__(self, events, window_s: float, config: dict, traffic: dict,
                 model_calls: int = 0, steps: int = 0, calls: int = 0,
                 call_s: float | None = None):
        self.window_s = window_s
        self.config, self.traffic = config, traffic
        self.batch = int(traffic["batch"])
        self.model_calls, self.steps = model_calls, steps
        # the window's calls (requests or steps) traced, and the host
        # seconds an untraced call of the window took on average
        self.calls, self.call_s = calls, call_s
        device_ops, host_ops, launches = [], [], {}
        for e in events:
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                device_ops.append((e.start_ns(), e.duration_ns(), e.name(),
                                   e.correlation_id()))
            elif e.name().startswith(_LAUNCH_PREFIXES):
                launches[e.correlation_id()] = e.start_ns()
            else:
                host_ops.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                 e.name()))
        device_ops.sort()
        self.device_ops = [(s, d, n) for s, d, n, _ in device_ops]
        self.family_ns = defaultdict(int)
        self.name_ns = defaultdict(int)
        for _, d, n in self.device_ops:
            self.family_ns[family(n)] += d
            self.name_ns[n] += d
        self.busy_s = _union_ns(self.device_ops) / 1e9
        self.gap_ns = _gaps(device_ops, _outermost(host_ops), launches)

    @property
    def launches(self) -> int:
        return len(self.device_ops)

    def family_s(self, *families: str) -> float:
        return sum(self.family_ns.get(f, 0) for f in families) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.name_ns.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gap_ns.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:200], ns / 1e9] for n, ns in ops],
                "idle_gaps": [[n[:200], ns / 1e9] for n, ns in gaps]}


def _union_ns(ops) -> int:
    total, end = 0, None
    for s, d, _ in ops:
        e = s + d
        if end is None or s >= end:
            total += d
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _outermost(host_ops):
    """The host ops no other op encloses, sorted by start: (starts, ops)."""
    host_ops.sort(key=lambda o: (o[0], -o[1]))
    top, end = [], -1
    for s, e, n in host_ops:
        if s >= end:
            top.append((s, e, n))
            end = e
    return [o[0] for o in top], top


def _gaps(device_ops, outer, launches) -> dict:
    """Idle time between consecutive device operations, summed by the
    outermost host op that launched the operation ending the gap."""
    starts, top = outer
    out = defaultdict(int)
    end = None
    for s, d, _, corr in device_ops:
        if end is not None and s > end:
            name = "unattributed"
            at = launches.get(corr)
            if at is not None:
                i = bisect.bisect_right(starts, at) - 1
                name = (top[i][2] if i >= 0 and top[i][1] >= at
                        else "host between ops")
            out[name] += s - end
        end = s + d if end is None else max(end, s + d)
    return out
