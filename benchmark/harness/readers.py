"""What the per-layer metric files compute from a traced ``View``; each
``benchmark/metrics/<name>.py`` binds one of these as its ``read``. Every
reader returns None where the trace holds nothing for it to read."""
from __future__ import annotations

from .families import NORM_ELTWISE
from .peaks import PEAK_BF16_FLOPS, forward_attention_bound_s


def launches_per_call(view):
    """Device operations a model call."""
    if not view.model_calls or not view.launches:
        return None
    return view.launches / view.model_calls


def _ms(seconds, count):
    return 1e3 * seconds / count if count and seconds else None


def conv_ms_per_call(view):
    """Device ms of the convolution family a model call."""
    return _ms(view.family_s("convolution"), view.model_calls)


def norm_eltwise_ms_per_call(view):
    """Device ms of the GroupNorm, elementwise / reduce and copy / layout
    families a model call."""
    return _ms(view.family_s(*NORM_ELTWISE), view.model_calls)


def norm_eltwise_ms_per_step(view):
    """The same families' device ms a train step."""
    return _ms(view.family_s(*NORM_ELTWISE), view.steps)


def optimizer_ms_per_step(view):
    """Device ms of the foreach / multi-tensor family a train step."""
    return _ms(view.family_s("optimizer (foreach)"), view.steps)


def attn_roofline(view):
    """% of its roofline the attention kernel reaches: the least time of
    the traced model calls' attention (the configuration's
    ``attention_calls`` at the cell's batch) over the kernels' time."""
    s = view.family_s("flash_attention")
    if not view.model_calls or not s:
        return None
    bound = forward_attention_bound_s(view.config, view.batch) * view.model_calls
    return 100.0 * bound / s


def _busy_share(view):
    """The traced calls' device busy time a call over an untraced call's
    host time in the same window."""
    if not view.launches or not view.calls or not view.call_s:
        return None
    return view.busy_s / view.calls / view.call_s


def idle_share(view):
    """% of an untraced call's time with no device operation running: the
    traced calls' device busy time a call against the host time an
    untraced call of the same window took (the profiler slows the host, so
    the traced window's own idle share reads high where the host paces)."""
    busy = _busy_share(view)
    return None if busy is None else 100.0 * (1.0 - busy)


def _mfu(view, flops_per_call):
    if not view.launches or not view.calls or not view.call_s:
        return None
    return 100.0 * flops_per_call / view.call_s / PEAK_BF16_FLOPS


def mfu_serve(view):
    """% of the bf16 dense peak: the configuration's forward FLOPs a slice,
    times the batch and the model calls a request, over an untraced
    request's time."""
    if not view.model_calls:
        return None
    return _mfu(view, view.config["forward_flops_per_sample"] * view.batch
                * view.model_calls / max(view.calls, 1))


def mfu_train(view):
    """% of the bf16 dense peak: three forwards' FLOPs a step (forward and
    backward; the remat recompute not counted), over an untraced step's
    time."""
    if not view.steps:
        return None
    return _mfu(view, 3 * view.config["forward_flops_per_sample"] * view.batch)
