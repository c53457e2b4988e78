"""The ResBlock norm site's op on the CPU: ``ops.group_norm_film_silu``,
``SiLU(GroupNorm32(x) * (1 + scale) + shift)``, and the models' dispatch.

- The plain version is ``GroupNorm32`` -> FiLM -> SiLU in f32 (to 1e-6,
  groups other than 32 and eps 1e-6 included), keeps x's memory format,
  and in bf16 is the f32 result rounded once.
- The NCHW kernels' plan (``nchw_chunking``) and arithmetic, emulated: f64
  sums per chunk of a (batch, group) run reduced in order, a and b folded
  with the FiLM, each 16-byte vector's channel from its offset, against
  the plain version.
- ``GroupNorm32.silu`` takes the op, and counts ``model.norm_fused``, where
  no gradient is recorded (``inference_mode``, ``no_grad``, a frozen
  block); the eager chain where one is, with no count: a ResBlock, a DDIM
  request (every site of every model call) and a train step (none).
- The CUDA wrapper refuses a CPU tensor and inputs that require a
  gradient (``needs_grad``, the predicate ``GroupNorm32.silu`` dispatches
  on); the op entry on a CPU tensor launches nothing; its launch plans are
  cached, at most ``_PLANS_MAX`` of them.
The kernels themselves: ``tests/test_torch_norm_film_gpu.py``, on a card.
"""
from collections import defaultdict

import pytest
import torch
import torch.nn.functional as F

from dsdiff_torch import ops
from dsdiff_torch.models import layers
from dsdiff_torch.models.layers import GroupNorm32, ResBlock
from dsdiff_torch.ops import fused_norm as PF
from dsdiff_torch.train.trainer import Trainer
from dsdiff_torch.utils import profiling
from torch_parity_utils import TINY, one_thread, tiny_cfg  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(autouse=True)
def tracer_state(monkeypatch):
    """Each test starts and ends with the tracer off and drained, and
    leaves the process's span totals (``scope_totals``, which ``drain``
    keeps) as it found them, for the other files a worker runs."""
    monkeypatch.setattr(profiling, "_host_ns", defaultdict(int))
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


def _inputs(B, C, H, W, film=True, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(B, C, H, W, generator=g) * 2.0 + 0.5).to(dtype)
    norm = GroupNorm32(C)
    with torch.no_grad():
        norm.norm.weight.normal_(1.0, 0.1, generator=g)
        norm.norm.bias.normal_(0.0, 0.1, generator=g)
    scale = shift = None
    if film:
        emb = (torch.randn(B, 2 * C, 1, 1, generator=g) * 0.3).to(dtype)
        scale, shift = emb.chunk(2, dim=1)
    return x, norm, scale, shift


def _eager(norm, x, scale, shift):
    h = norm(x)
    if scale is not None:
        h = h * (1.0 + scale) + shift
    return F.silu(h)


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("B, C, H, W", [(2, 64, 6, 5), (1, 40, 4, 4),
                                        (3, 96, 8, 8), (2, 6, 3, 7)])
def test_plain_version_is_the_f32_chain(B, C, H, W, film, layout):
    """GroupNorm32's groups (40 channels: 20, 6: 6) and eps 1e-6."""
    x, norm, scale, shift = _inputs(B, C, H, W, film)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    G = norm.norm.num_groups
    assert G == {64: 32, 40: 20, 96: 32, 6: 6}[C]
    with torch.no_grad():
        want = _eager(norm, x, scale, shift)
        got = PF.group_norm_film_silu_plain(x, norm.norm.weight,
                                            norm.norm.bias, G, scale, shift,
                                            GroupNorm32.EPS)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert got.is_contiguous(
        memory_format=torch.channels_last
        if layout == "channels_last" else torch.contiguous_format)


def test_plain_version_rounds_bf16_once():
    x, norm, scale, shift = _inputs(2, 64, 4, 4, dtype=torch.bfloat16)
    w, b, G = norm.norm.weight, norm.norm.bias, norm.norm.num_groups
    got = PF.group_norm_film_silu_plain(x, w, b, G, scale, shift)
    f32 = PF.group_norm_film_silu_plain(x.float(), w, b, G, scale.float(),
                                        shift.float())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, f32.bfloat16())


@pytest.mark.parametrize("B, G, run, vector", [
    (8, 32, 3 * 256 * 256, 8), (8, 32, 6 * 256 * 256, 8),
    (1, 32, 3 * 256 * 256, 8), (8, 32, 9 * 8 * 8, 8), (8, 32, 6 * 32 * 32, 8),
    (8, 32, 3 * 64 * 64, 8), (8, 32, 48 * 32 * 32, 8), (8, 32, 3 * 128 * 128, 4),
    (1, 1, 35, 8), (2, 20, 2 * 35, 4), (64, 32, 3 * 256 * 256, 8)])
def test_nchw_chunking_covers_every_element_once(B, G, run, vector):
    """Chunks of a multiple of 8 elements (each starts 16-byte aligned),
    covering the run with only the last ragged; no more chunks than about
    four blocks an SM or a thread's 32 loads ask for, nor than give a
    thread 4 loads; one chunk (one launch) for a run of 4 loads a thread."""
    length, chunks = PF.nchw_chunking(B, G, run, vector)
    assert length % 8 == 0 and length > 0 and chunks >= 1
    assert (chunks - 1) * length < run <= chunks * length
    lo, hi = PF._THREADS * vector * 4, PF._THREADS * vector * 32
    want = max(-(-PF._NCHW_BLOCKS // (B * G)), -(-run // hi))
    assert chunks <= max(1, min(want, -(-run // lo)))
    assert length <= hi + 8
    if run <= lo:
        assert chunks == 1


def _emulate_nchw(x, gamma, beta, G, scale, shift, eps, vector):
    """The NCHW kernels' arithmetic: f64 sums per chunk of each (batch,
    group) run, reduced over the chunks in order; mean, var, a and b in f64
    with the FiLM folded in, rounded to f32; each vector of ``vector``
    elements takes the (a, b) of the channel its offset falls in."""
    B, C, H, W = x.shape
    HW, cpg = H * W, C // G
    run = cpg * HW
    length, chunks = PF.nchw_chunking(B, G, run, vector)
    xr = x.double().reshape(B * G, run)
    sums = torch.zeros(B * G, 2, dtype=torch.float64)
    for i in range(chunks):
        part = xr[:, i * length:(i + 1) * length]
        sums[:, 0] += part.sum(dim=1)
        sums[:, 1] += (part * part).sum(dim=1)
    mean = sums[:, 0] / run
    var = (sums[:, 1] / run - mean**2).clamp_min(0.0)
    inv = 1.0 / torch.sqrt(var + eps)
    c = torch.arange(C)
    ga = inv.reshape(B, G).repeat_interleave(cpg, dim=1) * gamma.double()[c]
    a = ga
    b = beta.double()[c] - mean.reshape(B, G).repeat_interleave(cpg, 1) * ga
    if scale is not None:
        s1 = 1.0 + scale.double().reshape(B, C)
        a, b = a * s1, b * s1 + shift.double().reshape(B, C)
    a, b = a.float().reshape(B * G, cpg), b.float().reshape(B * G, cpg)
    offset = torch.arange(run)
    j = (offset // vector * vector) // HW  # a vector's first element's channel
    y = xr.float() * a[:, j] + b[:, j]
    return F.silu(y).reshape(B, C, H, W)


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("B, C, H, W, vector", [
    (2, 96, 16, 16, 8), (1, 64, 32, 32, 8), (2, 40, 8, 8, 4), (1, 96, 64, 64, 8)])
def test_nchw_kernel_arithmetic_emulated(B, C, H, W, vector, film):
    x, norm, scale, shift = _inputs(B, C, H, W, film, seed=3)
    G = norm.norm.num_groups
    got = _emulate_nchw(x, norm.norm.weight.detach(), norm.norm.bias.detach(),
                        G, scale, shift, GroupNorm32.EPS, vector)
    with torch.no_grad():
        want = _eager(norm, x, scale, shift)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _resblock(seed=0):
    torch.manual_seed(seed)
    block = ResBlock(32, 16, 64, use_scale_shift_norm=True)
    with torch.no_grad():
        for p in block.parameters():
            p.normal_(0.0, 0.2)
    return block


def _counted(fn):
    """(fn's result, model.norm_fused counted while it ran)."""
    profiling.enable()
    try:
        out = fn()
    finally:
        profiling.disable()
    return out, profiling.drain()["counts"].get("model.norm_fused", 0)


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad", "frozen"])
def test_resblock_takes_the_op_where_no_gradient_is_recorded(mode,
                                                             monkeypatch):
    block = _resblock()
    x = torch.randn(2, 32, 8, 8)
    emb = torch.randn(2, 16)
    want = block(x, emb)  # grad on: the eager chain
    calls = []
    real = PF.group_norm_film_silu_plain
    monkeypatch.setattr(PF, "group_norm_film_silu_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    if mode == "frozen":
        block.requires_grad_(False)
        ctx = torch.enable_grad()
    else:
        ctx = getattr(torch, mode)()
    with ctx:
        got, counted = _counted(lambda: block(x, emb))
    assert len(calls) == 2 and counted == 2
    torch.testing.assert_close(got, want.detach(), rtol=0, atol=1e-6)


def test_resblock_takes_the_eager_chain_where_a_gradient_is_recorded(
        monkeypatch):
    block = _resblock()
    x = torch.randn(2, 32, 8, 8, requires_grad=True)
    emb = torch.randn(2, 16)
    monkeypatch.setattr(layers, "group_norm_film_silu", None)  # not called
    out, counted = _counted(lambda: block(x, emb))
    assert counted == 0
    out.sum().backward()
    assert x.grad is not None and block.in_norm.norm.weight.grad is not None


def _norm_sites(model) -> int:
    """The norm sites of one forward: two a ResBlock, one an OutHead."""
    from dsdiff_torch.models.backbone import OutHead

    return sum(2 if isinstance(m, ResBlock) else 1
               for m in model.modules() if isinstance(m, (ResBlock, OutHead)))


@pytest.mark.parametrize("net_mode", ["ds_diff_gaussian", "disc_diff"])
def test_request_counts_every_site_and_a_train_step_none(net_mode):
    cfg = tiny_cfg(2)
    cfg.update(image_size=16, net_mode=net_mode)
    trainer = Trainer(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    cond = torch.rand((2, 16, 16, trainer.n_cond), generator=g) * 2 - 1
    x_T = torch.randn((2, 16, 16, 1), generator=g)
    profiling.enable()
    try:
        trainer.sample_fn(cond, None, x_T)
    finally:
        profiling.disable()
    spans = profiling.drain()["spans"]
    parent = {r.id: r.parent for r in spans}

    def inside(r, call):  # r is the call or opened within it
        i = r.id
        while i is not None and i != call.id:
            i = parent[i]
        return i == call.id

    calls = [r for r in spans if r.name == "model.forward"]
    sites = _norm_sites(trainer.sample_model)
    assert len(calls) == 2
    per_call = [sum(r.counts.get("model.norm_fused", 0) for r in spans
                    if inside(r, c)) for c in calls]
    assert per_call == [sites] * 2
    batch = {"target": torch.rand((2, 16, 16, 1), generator=g) * 2 - 1,
             "image": torch.rand((2, 16, 16, trainer.n_cond), generator=g)}
    _, counted = _counted(lambda: trainer.train_step(
        batch, torch.Generator().manual_seed(1)))
    assert counted == 0


def test_cuda_wrapper_refuses_cpu_tensors_and_inputs_needing_grad():
    x, norm, scale, shift = _inputs(1, 32, 4, 4)
    w, b = norm.norm.weight, norm.norm.bias
    with pytest.raises(RuntimeError, match="no backward"):
        PF.group_norm_film_silu(x, w, b, 32, scale, shift)  # w needs grad
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        PF.group_norm_film_silu(x, w, b, 32, scale, shift)
    before = PF.LAUNCHES
    with torch.no_grad():
        y = ops.group_norm_film_silu(x, w, b, 32, scale, shift)
    assert PF.LAUNCHES == before and y.shape == x.shape


@pytest.mark.parametrize("needs", ["x", "gamma", "beta", "scale", "shift",
                                   None])
@pytest.mark.parametrize("grad_mode", [True, False])
def test_needs_grad_is_grad_mode_and_any_input_requiring_one(needs,
                                                             grad_mode):
    x, norm, scale, shift = _inputs(1, 32, 2, 2)
    inputs = dict(x=x, gamma=norm.norm.weight.detach(),
                  beta=norm.norm.bias.detach(), scale=scale, shift=shift)
    if needs is not None:
        inputs[needs] = inputs[needs].clone().requires_grad_(True)
    with torch.set_grad_enabled(grad_mode):
        got = PF.needs_grad(**inputs)
        no_film = PF.needs_grad(inputs["x"], inputs["gamma"], inputs["beta"])
    assert got == (grad_mode and needs is not None)
    assert no_film == (grad_mode and needs in ("x", "gamma", "beta"))


def test_plans_are_cached_by_layout_and_bounded(monkeypatch):
    built = []
    monkeypatch.setattr(PF, "_film_plan",
                        lambda *args: built.append(args[0].shape) or ("plan",))
    monkeypatch.setattr(PF, "_PLANS", {})
    _, norm, _, _ = _inputs(1, 32, 2, 2, film=False)
    w, b = norm.norm.weight, norm.norm.bias
    x = torch.zeros(1, 32, 2, 2)
    assert PF._plan(x, w, b, 32, None, None) == ("plan",)
    assert PF._plan(torch.ones(1, 32, 2, 2), w, b, 32, None, None) == ("plan",)
    assert len(built) == 1  # same shapes, strides, dtypes: the cached plan
    PF._plan(x.contiguous(memory_format=torch.channels_last), w, b, 32, None,
             None)
    assert len(built) == 2  # another layout, another plan
    for h in range(3, 3 + PF._PLANS_MAX + 10):
        PF._plan(torch.zeros(1, 32, h, 2), w, b, 32, None, None)
    assert len(PF._PLANS) == PF._PLANS_MAX
    assert len(built) == 2 + PF._PLANS_MAX + 10
    PF._plan(x, w, b, 32, None, None)  # dropped as the oldest: built again
    assert len(built) == 3 + PF._PLANS_MAX + 10
