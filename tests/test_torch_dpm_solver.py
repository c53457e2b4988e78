"""``dsdiff_torch.core.dpm_solver`` against the JAX package's, f32 on the CPU.

The denoiser is analytic (smooth in x and t), so both sides do the same
float32 arithmetic on the same float32 tables and the same host float64
step grids. What differs is the order of fused operations, and the chain
carries it: 2e-5 absolute on outputs of magnitude ~1. The schedule's
interpolation is held to ``np.interp`` in float64 within float32 rounding
(1e-6 of the table's magnitude).

The adaptive controller turns an ulp in its error norm into another step
size, and the grid carries that into the result: the jitted JAX solver
differs from the same JAX code run eagerly by up to ~4e-5 here, and so from
the port. Against the eager JAX run the port agrees to 2e-6 and makes the
same number of model calls; against the jitted one it is held to 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.core import dpm_solver as JDS
from dsdiff_tpu.core import schedules as JSch
from dsdiff_torch.core import dpm_solver as PDS
from dsdiff_torch.core import schedules as PSch

ATOL = 2e-5
ADAPTIVE_JIT_ATOL = 1e-4
ADAPTIVE_EAGER_ATOL = 2e-6
BETAS = JSch.make_beta_schedule("scaled_linear", 1000)
JSCHED = JSch.DiffusionSchedule.create(BETAS)
PSCHED = PSch.DiffusionSchedule.create(BETAS, device="cpu")
JNS = JDS.NoiseScheduleVP.from_betas(np.asarray(JSCHED.betas))
PNS = PDS.NoiseScheduleVP.from_betas(PSCHED.betas.numpy())


def _x(seed=0, shape=(2, 8, 8, 1)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _smooth(lib, scale=0.5):
    """x0-prediction smooth in t and x; ``lib`` is jnp or torch."""

    def denoise(x, t_model):
        t_cont = (t_model.reshape(-1, 1, 1, 1) + 1.0) / 1000.0
        return scale * lib.sin(3.0 * t_cont) + 0.2 * lib.tanh(x)

    return denoise


def _counted(fn):
    calls = []

    def wrapped(x, t):
        calls.append(1)
        return fn(x, t)

    return wrapped, calls


# tests/test_dpm_solver.py's parametrisation: method x order x skip x algorithm
CASES = [
    ("singlestep", 1, "time_uniform", "dpmsolver++"),
    ("singlestep", 2, "time_uniform", "dpmsolver++"),
    ("singlestep", 3, "time_uniform", "dpmsolver++"),
    ("singlestep", 3, "logSNR", "dpmsolver"),
    ("singlestep_fixed", 2, "time_quadratic", "dpmsolver++"),
    ("multistep", 1, "time_uniform", "dpmsolver++"),
    ("multistep", 2, "logSNR", "dpmsolver"),
    ("multistep", 3, "time_uniform", "dpmsolver++"),
    ("multistep", 3, "logSNR", "dpmsolver"),
    ("adaptive", 2, "time_uniform", "dpmsolver++"),
    ("adaptive", 3, "time_uniform", "dpmsolver"),
]


@pytest.mark.parametrize("method,order,skip,algo", CASES)
def test_sample_matches_jax(method, order, skip, algo):
    x_T = _x(1)
    kw = dict(steps=9, order=order, method=method, skip_type=skip,
              algorithm_type=algo, parameterization="x0")
    want = JDS.sample(JSCHED, _smooth(jnp), jnp.asarray(x_T), **kw)
    fn, calls = _counted(_smooth(torch))
    got = PDS.sample(PSCHED, fn, torch.from_numpy(x_T), **kw)
    atol = ADAPTIVE_JIT_ATOL if method == "adaptive" else ATOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)
    if method == "singlestep_fixed":
        assert len(calls) == 2 * (9 // 2)
    elif method != "adaptive":
        assert len(calls) == 9  # one model call per step, none after the last


@pytest.mark.parametrize("order, algo", [(2, "dpmsolver"),
                                         (3, "dpmsolver++")])
def test_adaptive_matches_jax_in_result_and_model_calls(order, algo):
    """The controller accepts and rejects the same steps: the same result
    and the same count of model calls (the JAX loop run eagerly, so that
    its calls can be counted)."""
    x_T = _x(2)
    kw = dict(order=order, method="adaptive", algorithm_type=algo,
              parameterization="x0")
    jfn, jcalls = _counted(_smooth(jnp))
    with jax.disable_jit():
        want = JDS.sample(JSCHED, jfn, jnp.asarray(x_T), **kw)
    pfn, pcalls = _counted(_smooth(torch))
    got = PDS.sample(PSCHED, pfn, torch.from_numpy(x_T), **kw)
    assert len(pcalls) == len(jcalls) > order
    assert len(pcalls) % order == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ADAPTIVE_EAGER_ATOL)


def test_adaptive_gates_on_the_worst_sample_and_stops_at_its_cap():
    hi = torch.zeros(2, 4, 4, 1)
    lo = torch.zeros(2, 4, 4, 1)
    lo[1] = 1.0  # one far-off sample in an easy batch
    err = PDS._adaptive_error(hi, lo, lo, atol=0.1, rtol=0.0)
    want = JDS._adaptive_error(jnp.asarray(hi.numpy()), jnp.asarray(lo.numpy()),
                               jnp.asarray(lo.numpy()), 0.1, 0.0)
    assert float(err) == pytest.approx(float(want)) == pytest.approx(10.0)
    fn, calls = _counted(lambda x, t: torch.sign(torch.sin(40.0 * x)))
    out = PDS._sample_adaptive(PNS, PDS.wrap_model(fn, PNS, "x0"),
                               torch.from_numpy(_x(3)), 1.0, PNS.t_0, 3, True,
                               atol=1e-7, rtol=1e-7, max_nfe=30)
    assert len(calls) == 30 and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="order 2 or 3"):
        PDS._sample_adaptive(PNS, fn, out, 1.0, PNS.t_0, 1, True)


@pytest.mark.parametrize("steps, lower_order_final", [(4, True), (4, False),
                                                      (12, True)])
def test_multistep_order_ramp_matches_jax(steps, lower_order_final):
    x_T = _x(4)
    kw = dict(steps=steps, order=3, method="multistep", skip_type="logSNR",
              parameterization="x0", lower_order_final=lower_order_final)
    want = JDS.sample(JSCHED, _smooth(jnp), jnp.asarray(x_T), **kw)
    fn, calls = _counted(_smooth(torch))
    got = PDS.sample(PSCHED, fn, torch.from_numpy(x_T), **kw)
    assert len(calls) == steps
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_noise_schedule_tables_match_jax():
    np.testing.assert_array_equal(PNS.t_array.numpy(), np.asarray(JNS.t_array))
    np.testing.assert_array_equal(PNS.log_alpha_array.numpy(),
                                  np.asarray(JNS.log_alpha_array))
    np.testing.assert_array_equal(PNS.t_np, JNS.t_np)
    np.testing.assert_array_equal(PNS.log_alpha_np, JNS.log_alpha_np)
    assert (PNS.total_N, PNS.t_0, PNS.t_T) == (JNS.total_N, JNS.t_0, JNS.t_T)
    t = np.concatenate([
        np.linspace(1e-3, 1.0, 37), [0.5, 0.0004, 1.2, 0.25 + 1e-4]
    ]).astype(np.float32)
    for name in ("marginal_log_mean_coeff", "marginal_alpha", "marginal_std",
                 "marginal_lambda"):
        got = getattr(PNS, name)(torch.from_numpy(t)).numpy()
        want = np.asarray(getattr(JNS, name)(jnp.asarray(t)))
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6,
                                   err_msg=name)
    lam = np.linspace(-6.0, 10.5, 41).astype(np.float32)
    np.testing.assert_allclose(
        PNS.inverse_lambda(torch.from_numpy(lam)).numpy(),
        np.asarray(JNS.inverse_lambda(jnp.asarray(lam))), rtol=2e-6, atol=1e-7)
    # a scalar time, as the solver passes it
    got = PNS.marginal_lambda(PNS.time(0.5))
    assert got.shape == () and float(got) == pytest.approx(
        float(JNS.marginal_lambda(jnp.float32(0.5))), rel=2e-6)


def test_interp_matches_numpy():
    rng = np.random.default_rng(5)
    xp = np.sort(rng.uniform(-3, 3, 50)).astype(np.float32)
    fp = rng.standard_normal(50).astype(np.float32)
    x = np.concatenate([
        rng.uniform(-3.5, 3.5, 200), xp[[0, 7, 49]],  # on the knots too
        [-10.0, 10.0],                                # clamped at both ends
    ]).astype(np.float32)
    got = PDS._interp(torch.from_numpy(x), torch.from_numpy(xp),
                      torch.from_numpy(fp)).numpy()
    want = np.interp(x.astype(np.float64), xp.astype(np.float64),
                     fp.astype(np.float64))
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(fp).max())
    assert got[-2] == fp[0] and got[-1] == fp[-1]
    one = PDS._interp(torch.tensor(0.3), torch.from_numpy(xp),
                      torch.from_numpy(fp))
    assert one.shape == () and float(one) == pytest.approx(
        float(np.interp(0.3, xp, fp)), abs=1e-6)


@pytest.mark.parametrize("skip", ["logSNR", "time_uniform", "time_quadratic"])
def test_step_grids_match_jax(skip):
    for n in (1, 7, 20):
        np.testing.assert_array_equal(
            PDS._get_time_steps(PNS, skip, 1.0, PNS.t_0, n),
            JDS._get_time_steps(JNS, skip, 1.0, JNS.t_0, n))
    with pytest.raises(ValueError, match="unsupported skip_type"):
        PDS._get_time_steps(PNS, "cosine", 1.0, PNS.t_0, 4)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_singlestep_orders_match_jax(order):
    for steps in range(3, 24):
        got = PDS._orders_for_singlestep(steps, order)
        assert got == JDS._orders_for_singlestep(steps, order)
        assert sum(got) == steps
    # 20 steps at order 3: six groups of 3 and one of 2, 20 model calls
    assert PDS._orders_for_singlestep(20, 3) == [3] * 6 + [2]
    with pytest.raises(ValueError, match="order must be 1..3"):
        PDS._orders_for_singlestep(9, 4)


@pytest.mark.parametrize("parameterization", ["eps", "x0", "v"])
@pytest.mark.parametrize("algo", ["dpmsolver++", "dpmsolver"])
def test_wrap_model_matches_jax(parameterization, algo):
    """Learned sigma's half is dropped, the model is fed (t N - 1) * rescale
    as a [B] f32 tensor, and ``denoised_fn`` applies before the clip."""
    x = 1.5 * _x(6, (2, 4, 4, 1))
    seen = {}

    def jmodel(xx, t_model):
        seen["j"] = np.asarray(t_model)
        out = 0.7 * xx + 0.1
        return jnp.concatenate([out, jnp.zeros_like(out)], axis=-1)

    def pmodel(xx, t_model):
        seen["p"] = t_model
        out = 0.7 * xx + 0.1
        return torch.cat([out, torch.zeros_like(out)], dim=-1)

    kw = dict(parameterization=parameterization, learn_sigma=True,
              rescale_factor=0.5, clip_denoised=True, algorithm_type=algo)
    want = JDS.wrap_model(jmodel, JNS, denoised_fn=lambda v: 3.0 * v, **kw)(
        jnp.asarray(x), jnp.float32(0.5))
    got = PDS.wrap_model(pmodel, PNS, denoised_fn=lambda v: 3.0 * v, **kw)(
        torch.from_numpy(x), PNS.time(0.5))
    assert seen["p"].shape == (2,) and seen["p"].dtype == torch.float32
    np.testing.assert_array_equal(seen["p"].numpy(), seen["j"])
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # 3 x0 saturates the clip where x0 alone would not: denoised_fn came first
    if algo == "dpmsolver++":
        assert (got.abs() == 1.0).any()
    with pytest.raises(ValueError, match="unknown parameterization"):
        PDS.wrap_model(pmodel, PNS, "score")(torch.from_numpy(x),
                                             PNS.time(0.5))


def test_v_param_and_learn_sigma_wrapper():
    """A v-model consistent with x0 = 0.2 gives x0 = 0.2 back."""
    x = torch.from_numpy(_x(7, (2, 4, 4, 1)))
    t = PNS.time(0.5)
    a, s = PNS.marginal_alpha(t), PNS.marginal_std(t)

    def v_model(xx, t_model):
        v = (a * xx - 0.2) / s
        return torch.cat([v, torch.zeros_like(v)], dim=-1)

    fn = PDS.wrap_model(v_model, PNS, parameterization="v", learn_sigma=True)
    np.testing.assert_allclose(fn(x, t).numpy(), 0.2, atol=1e-5)


def test_default_entry_matches_jax():
    """``dpm_solver_sample_loop``: DPM-Solver++ multistep order 2, logSNR,
    dynamic thresholding (the denoiser leaves [-1, 1], so it binds),
    lower_order_final=False; overrides pass through."""
    x_T = _x(8)
    want = JDS.dpm_solver_sample_loop(JSCHED, _smooth(jnp, 1.6),
                                      jnp.asarray(x_T), steps=10,
                                      parameterization="x0")
    fn, calls = _counted(_smooth(torch, 1.6))
    got = PDS.dpm_solver_sample_loop(PSCHED, fn, torch.from_numpy(x_T),
                                     steps=10, parameterization="x0")
    assert len(calls) == 10
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    plain = PDS.dpm_solver_sample_loop(PSCHED, fn, torch.from_numpy(x_T),
                                       steps=10, parameterization="x0",
                                       denoised_fn=None)
    assert not torch.allclose(plain, got, atol=1e-3)
    want3 = JDS.dpm_solver_sample_loop(
        JSCHED, _smooth(jnp), jnp.asarray(x_T), steps=10,
        parameterization="x0", method="singlestep", order=3,
        skip_type="time_uniform", denoise_to_zero=True)
    got3 = PDS.dpm_solver_sample_loop(
        PSCHED, _smooth(torch), torch.from_numpy(x_T), steps=10,
        parameterization="x0", method="singlestep", order=3,
        skip_type="time_uniform", denoise_to_zero=True)
    np.testing.assert_allclose(got3.numpy(), np.asarray(want3), atol=ATOL)


def test_sample_refuses_a_respaced_schedule_and_unknown_methods():
    rs = PSch.respace(BETAS, PSch.space_timesteps(1000, "20"), device="cpu")
    x = torch.from_numpy(_x(9))
    with pytest.raises(ValueError, match="full schedule"):
        PDS.sample(rs, _smooth(torch), x)
    with pytest.raises(ValueError, match="unknown method"):
        PDS.sample(PSCHED, _smooth(torch), x, method="heun")
