"""The comparison that decides ``correct``: what the timed path produced,
held against the plain f32 reference (``benchmark.reference``, TF32 off),
which is built after the window from the same seed and never sees the
program's weights or state.

Serve cells (``serve_numbers``): the reference follows each sampled
request step by step from the program's own chain. Given the program's x
at step i and the request's conditions, it runs its own forward and its own
DDIM step (eta 0, x0 clipped) and compares the x it gets with the program's
x at step i + 1 (the request's output after the last step): the widest
element gap (``step_gap_max``) and the largest per-step RMS gap
(``step_gap_rms``). The start is checked apart and exactly: the program's
first x is the x_T the benchmark gave it, the conditions reach every call
unchanged, and a request makes one model call a step.

Train cells (``train_numbers``): the reference takes the same first three
steps (same rows, t and noise) from the same weights. Compared: the first
gradient (read from AdamW's first moment after one step: mu = (1 - b1) g)
by its median leaf's difference norm against the larger of that leaf's
reference norm and the median leaf's (``grad_diff``); how far that
gradient leans toward one half of the batch (``half_lean``: the reference
also takes the gradient of each half alone, g_A and g_B, and half_lean =
|2 <g_program - g_reference, g_A - g_B>| / |g_A - g_B|^2, which reads 0
where every row weighs as the reference weighs it and about 1 where the
second half is left out); and by the worst leaf, against the same scale,
the gap of the norms of the parameters' change after three steps and of
the EMA's (``change_gap``, ``ema_gap``). Elements whose first reference
gradient is under 1e-3 of the median leaf's RMS gradient move by round-off
alone under Adam (a bias before a GroupNorm, the key third of a fused qkv
bias under softmax) and are left out of the two change numbers.
"""
from __future__ import annotations

import contextlib

import torch

from . import weights
from ..reference import diffusion, layers, models, optim

# an element whose reference gradient is under this share of the median
# leaf's RMS gradient moves by round-off alone under Adam
STILL_LEAF = 1e-3
# compared exactly: the program's start and its calls
EXACT = ("start_gap", "cond_gap", "calls_off")


@contextlib.contextmanager
def reference_mode(precision: str = "f32", remat: bool = False):
    """The reference's arithmetic: f32 with TF32 off (or the fp8 control),
    restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32, dict(layers.PRECISION))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    layers.set_precision(precision)
    layers.set_remat(remat)
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved[:2]
        layers.PRECISION.update(saved[2])


def reference_model(config: dict, wseed: int, device):
    model = models.build(config, device)
    weights.fill(model, wseed)
    return model


def _max(a, b):
    return b if a is None else max(a, b)


@torch.no_grad()
def reference_stepper(config: dict, steps: int, wseed: int, device):
    """``step(x, cond, i)``: the reference's forward and DDIM step (eta 0,
    x0 clipped as the configuration says) from x at step i. Call it under
    ``reference_mode``."""
    tr = config["trainer"]
    param = tr.get("parameterization", "v")
    clip = bool(tr.get("clip_denoised", True))
    ref = reference_model(config, wseed, device).eval()
    sched = diffusion.Schedule.respaced(tr, steps, device)

    def step(x, cond, i):
        out, _ = ref(torch.cat([x, cond], dim=-1),
                     diffusion.step_timestep(sched, x, i))
        return diffusion.ddim_step(sched, out, x, i, param, clip)

    return step


@torch.no_grad()
def serve_numbers(config: dict, traffic: dict, wseed: int, device, pool,
                  records, precision: str = "f32") -> dict:
    """``records``: (request index, [recorded model inputs], output) of the
    sampled requests. Returns the numbers compared (module docstring)."""
    steps = int(traffic["sample_steps"])
    nums = {k: 0.0 for k in EXACT}
    nums.update(step_gap_max=None, step_gap_rms=None)
    with reference_mode(precision):
        step = reference_stepper(config, steps, wseed, device)
        for idx, inputs, output in records:
            cond, x_T = pool.request(idx)
            nums["calls_off"] = max(nums["calls_off"],
                                    float(abs(len(inputs) - steps)))
            if len(inputs) != steps:
                continue
            xs = [x[..., :1] for x in inputs] + [output]
            nums["start_gap"] = max(nums["start_gap"],
                                    float((xs[0] - x_T).abs().max()))
            for x in inputs:
                nums["cond_gap"] = max(nums["cond_gap"],
                                       float((x[..., 1:] - cond).abs().max()))
            for i in range(steps):
                d = xs[i + 1] - step(xs[i].float(), cond, i)
                nums["step_gap_max"] = _max(nums["step_gap_max"],
                                            float(d.abs().max()))
                nums["step_gap_rms"] = _max(nums["step_gap_rms"],
                                            float(d.pow(2).mean().sqrt()))
        del step
    return nums


class TrainReadings:
    """One side's readings over the first three steps: each step's loss,
    the first gradient (the reference's elements also decide which ones the
    change numbers count) and,
    after step 3, the change of the parameters and of the EMA from the
    seeded weights, element by element (the program's kept on the host)."""

    def __init__(self, b1: float):
        self.b1 = b1
        self.losses, self.grad_t = [], None
        self.change, self.ema = None, None
        # the reference's first gradient of the batch's first half less
        # that of its second half, each half alone
        self.half_gap = None

    def after_step(self, k: int, metrics: dict, snapshot, wseed: int,
                   device) -> None:
        """The program's readings, from the state it reports after step
        ``k`` (0-based): the first gradient from AdamW's first moment
        (mu = (1 - b1) g after one step)."""
        self.losses.append(float(metrics["loss"]))
        if k == 0:
            self.grad_t = {n: (m.float() / (1.0 - self.b1)).cpu()
                           for n, m in snapshot()["mu"].items()}
        if k == 2:
            snap = snapshot()
            p0 = weights.values([(n, p.shape) for n, p in snap["params"].items()],
                                wseed, device)
            self.change = {n: (p.detach().float() - p0[n]).cpu()
                           for n, p in snap["params"].items()}
            self.ema = {n: (e.float() - p0[n]).cpu()
                        for n, e in snap["ema"].items()}
            del p0


def reference_train_readings(config: dict, wseed: int, device, fed,
                             precision: str = "f32") -> TrainReadings:
    """The reference's readings over the fed (batch, t, noise) steps."""
    tr = config["trainer"]
    out = TrainReadings(float(tr.get("beta1", 0.9)))
    with reference_mode(precision, remat=True):
        ref = reference_model(config, wseed, device).train()
        named = dict(ref.named_parameters())
        opt = optim.AdamWEma(list(named.values()), tr)
        sched = diffusion.Schedule.full(tr, device)
        for k, (batch, t, noise) in enumerate(fed):
            ref.zero_grad(set_to_none=True)
            loss = diffusion.train_objective(tr, sched, ref, batch["target"],
                                             batch["image"], t, noise)
            loss.backward()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in named.values()]
            out.losses.append(float(loss.detach()))
            if k == 0:
                out.grad_t = {n: g.detach().clone() for n, g in zip(named, grads)}
                out.half_gap = _half_gap(tr, sched, ref, named, batch, t, noise)
            opt.step(grads)
            del grads, loss
        ref.zero_grad(set_to_none=True)
        with torch.no_grad():
            p0 = weights.values([(n, p.shape) for n, p in named.items()],
                                wseed, device)
            out.change = {n: p.detach() - p0[n] for n, p in named.items()}
            out.ema = {n: e - p0[n] for n, e in zip(named, opt.ema)}
        del ref, opt, named, p0
    return out


def _half_gap(tr, sched, ref, named, batch, t, noise) -> dict:
    """g_A - g_B: the objective's gradient on the batch's first half alone
    less that on its second half alone."""
    h = t.shape[0] // 2
    halves = []
    for rows in (slice(0, h), slice(h, None)):
        ref.zero_grad(set_to_none=True)
        diffusion.train_objective(tr, sched, ref, batch["target"][rows],
                                  batch["image"][rows], t[rows],
                                  noise[rows]).backward()
        halves.append({n: p.grad.detach() if p.grad is not None
                       else torch.zeros_like(p) for n, p in named.items()})
    ref.zero_grad(set_to_none=True)
    return {n: halves[0][n] - halves[1][n] for n in named}


@torch.no_grad()
def _lean(prog: dict, ref: dict, half_gap: dict) -> float:
    """|2 <prog - ref, half_gap>| / |half_gap|^2 over every element."""
    num = den = 0.0
    for n, d in half_gap.items():
        d = d.double()
        num += float(((prog[n].to(d.device).double() - ref[n].double())
                      * d).sum())
        den += float((d * d).sum())
    return abs(2.0 * num) / max(den, 1e-300)


def _median(values):
    v = sorted(values)
    n = len(v)
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def leaf_gaps(prog: dict, ref: dict) -> list:
    """|prog - ref| / max(ref, the median leaf's ref), leaf by leaf."""
    med = _median(ref.values())
    return [abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in ref]


@torch.no_grad()
def _moving_norms(prog: dict, ref: dict, grad: dict) -> tuple[dict, dict]:
    """Leaf norms of the elements whose first reference gradient is at
    least ``STILL_LEAF`` of the median leaf's RMS gradient (the others move
    by round-off alone under Adam), for the program's and the reference's
    change; leaves with no such element are left out."""
    rms = {n: float(torch.linalg.vector_norm(g)) / g.numel() ** 0.5
           for n, g in grad.items()}
    floor = STILL_LEAF * _median(rms.values())
    p_out, r_out = {}, {}
    for n, g in grad.items():
        keep = g.abs() >= floor
        if not bool(keep.any()):
            continue
        p_out[n] = float(torch.linalg.vector_norm(prog[n].to(g.device)[keep]))
        r_out[n] = float(torch.linalg.vector_norm(ref[n].to(g.device)[keep]))
    return p_out, r_out


@torch.no_grad()
def _diff_gaps(prog: dict, ref: dict) -> list:
    """‖prog - ref‖ / max(‖ref‖, the median leaf's ‖ref‖), leaf by leaf."""
    ref_norms = {n: float(torch.linalg.vector_norm(r)) for n, r in ref.items()}
    med = _median(ref_norms.values())
    return [float(torch.linalg.vector_norm(prog[n].to(r.device) - r))
            / max(ref_norms[n], med, 1e-30) for n, r in ref.items()]


def train_numbers(prog: TrainReadings, ref: TrainReadings) -> dict:
    return {
        "grad_diff": _median(_diff_gaps(prog.grad_t, ref.grad_t)),
        "half_lean": _lean(prog.grad_t, ref.grad_t, ref.half_gap),
        "change_gap": max(leaf_gaps(*_moving_norms(prog.change, ref.change,
                                                   ref.grad_t))),
        "ema_gap": max(leaf_gaps(*_moving_norms(prog.ema, ref.ema,
                                                ref.grad_t))),
    }


def compare(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}}): the exact
    numbers of ``numbers`` at limit 0, then those ``limits`` names."""
    checks = {}
    for name in EXACT:
        if name in numbers:
            checks[name] = {"value": numbers[name], "limit": 0.0}
    for name, spec in limits["numbers"].items():
        checks[name] = {"value": numbers.get(name), "limit": spec["limit"]}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
