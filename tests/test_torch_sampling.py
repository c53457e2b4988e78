"""The samplers of ``dsdiff_torch.core.sampling`` against the JAX package's,
on the same schedule, x_T and (replayed) noise, f32 on the CPU.

With an analytic denoiser (elementwise in x and t) both sides do the same
float32 arithmetic on the same tables: 1e-5 absolute covers the order of
fused operations. With a tiny DSUNet the model's summation order differs
between XLA and PyTorch and is carried through the chain: 1e-4 absolute for
the chains clipped to [-1, 1], and 1e-4 of the largest magnitude for the
unclipped DDIM inversion; 3e-4 for PLMS, whose Adams-Bashforth formulas
weigh the eps predictions (and so their differences) by coefficients whose
magnitudes sum to 2 and 3.7, and which calls the model once more."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.core import sampling as JS
from dsdiff_tpu.core import schedules as JSch
from dsdiff_tpu.models.dsunet import DSUNet as JDSUNet
from dsdiff_torch.core import sampling as PS
from dsdiff_torch.core import schedules as PSch
from dsdiff_torch.models import build_model
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict
from torch_parity_utils import TINY, one_thread, random_flax_params

pytestmark = pytest.mark.usefixtures("one_thread")

ANALYTIC_ATOL = 1e-5
MODEL_ATOL = {"ancestral": 1e-4, "dpm++": 1e-4, "reverse": 1e-4,
              "plms": 3e-4}
STEPS = 5


def _scheds(steps=STEPS):
    betas = JSch.make_beta_schedule("scaled_linear", 1000)
    use = JSch.space_timesteps(1000, str(steps))
    return JSch.respace(betas, use), PSch.respace(betas, use, device="cpu")


def _x(seed=0, shape=(2, 8, 8, 1)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _analytic(np_like, learn_sigma):
    """A smooth denoiser, elementwise in x and t, for jnp or torch."""

    def fn(x, t_model):
        t = t_model.reshape(-1, 1, 1, 1)
        out = 0.3 * x + 0.1 * np_like.sin(t / 100.0)
        if learn_sigma:
            out = np_like.concatenate([out, 0.5 * np_like.cos(3.0 * x)], -1)
        return out

    return fn


def _torch_like():
    class T:
        sin, cos = staticmethod(torch.sin), staticmethod(torch.cos)

        @staticmethod
        def concatenate(xs, axis):
            return torch.cat(xs, dim=axis)

    return T


def _ancestral_noise(rng, steps, shape):
    """The draws of the JAX ``p_sample_loop`` body, in order."""
    noise = []
    for _ in range(steps):
        rng, key = jax.random.split(rng)
        noise.append(torch.from_numpy(np.array(
            jax.random.normal(key, shape, jnp.float32))))
    return noise


@pytest.mark.parametrize("learn_sigma, variance_type, guided", [
    (False, "fixed_small", False),
    (False, "fixed_large", False),
    (True, "fixed_small", False),
    (False, "fixed_small", True),
])
def test_p_sample_loop_matches_jax(learn_sigma, variance_type, guided):
    jsched, psched = _scheds()
    x_T = _x(1)
    rng = jax.random.PRNGKey(7)
    jguide = (lambda x, t: 0.2 * jnp.tanh(x)) if guided else None
    pguide = (lambda x, t: 0.2 * torch.tanh(x)) if guided else None
    want, want_x0s = JS.p_sample_loop(
        jsched, _analytic(jnp, learn_sigma), jnp.asarray(x_T), rng,
        parameterization="eps", learn_sigma=learn_sigma,
        variance_type=variance_type, collect_x0=True, guidance_fn=jguide,
    )
    got, got_x0s = PS.p_sample_loop(
        psched, _analytic(_torch_like(), learn_sigma), torch.from_numpy(x_T),
        parameterization="eps", learn_sigma=learn_sigma,
        variance_type=variance_type, collect_x0=True, guidance_fn=pguide,
        noise=_ancestral_noise(rng, STEPS, x_T.shape),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ANALYTIC_ATOL)
    np.testing.assert_allclose(got_x0s.numpy(), np.asarray(want_x0s),
                               atol=ANALYTIC_ATOL)


def test_stochastic_loops_need_a_noise_source_and_draw_from_the_generator():
    _, psched = _scheds()
    x_T = torch.from_numpy(_x(2))
    den = _analytic(_torch_like(), False)
    with pytest.raises(ValueError, match="generator or a list of noise"):
        PS.p_sample_loop(psched, den, x_T)
    a = PS.p_sample_loop(psched, den, x_T, torch.Generator().manual_seed(3))
    b = PS.p_sample_loop(psched, den, x_T, torch.Generator().manual_seed(3))
    c = PS.p_sample_loop(psched, den, x_T, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("parameterization", ["eps", "x0", "v"])
@pytest.mark.parametrize("name", ["dpm++", "plms"])
def test_deterministic_loops_match_jax(name, parameterization):
    jsched, psched = _scheds()
    x_T = _x(3)
    want = JS.make_sampler(name)(
        jsched, _analytic(jnp, True), jnp.asarray(x_T),
        parameterization=parameterization, learn_sigma=True,
    )
    got = PS.make_sampler(name)(
        psched, _analytic(_torch_like(), True), torch.from_numpy(x_T),
        parameterization=parameterization, learn_sigma=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ANALYTIC_ATOL)


@pytest.mark.parametrize("name, steps, calls", [
    ("plms", 5, 6),      # the first step calls the model twice
    ("plms", 1, 2),
    ("dpm++", 5, 5),     # T-1 updates and the last denoise
    ("ddim", 5, 5),
])
def test_model_calls_per_request(name, steps, calls):
    _, psched = _scheds(steps)
    den = _analytic(_torch_like(), False)
    seen = []

    def counted(x, t):
        seen.append(float(t[0]))
        return den(x, t)

    PS.make_sampler(name)(psched, counted, torch.from_numpy(_x(4)))
    assert len(seen) == calls
    if name == "plms":
        # the second call of the first step is at the next step's time
        assert seen[1] == seen[2] if steps > 1 else seen[1] == seen[0]


def test_ddim_reverse_loop_matches_jax():
    jsched, psched = _scheds(20)
    x_0 = np.clip(_x(5), -1, 1)
    want = JS.ddim_reverse_loop(jsched, _analytic(jnp, False),
                                jnp.asarray(x_0))
    den = _analytic(_torch_like(), False)
    got = PS.ddim_reverse_loop(psched, den, torch.from_numpy(x_0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ANALYTIC_ATOL)


@pytest.mark.parametrize("ratio, max_value", [(0.995, 1.0), (0.9, 1.0),
                                              (0.5, 2.0)])
def test_dynamic_threshold_matches_jax(ratio, max_value):
    x = 2.5 * _x(6, (3, 8, 8, 2))
    x[0] *= 0.1  # a sample wholly inside the range: s = max_value
    want = JS.dynamic_threshold(jnp.asarray(x), ratio, max_value)
    got = PS.dynamic_threshold(torch.from_numpy(x), ratio, max_value)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert got.abs().max() <= max_value


def test_make_sampler_registry_matches_jax():
    names = ["ddim", "plms", "dpm++", "dpm_solver++", "ancestral", "ddpm"]
    for name in names:
        assert PS.make_sampler(name).__name__ == JS.make_sampler(name).__name__
    for mod in (PS, JS):
        with pytest.raises(ValueError, match="unknown sampler"):
            mod.make_sampler("heun")
    assert sorted(PS.__all__) == sorted(JS.__all__)


# ----------------------------------------------------------- a tiny DSUNet
@pytest.fixture(scope="module")
def tiny_model():
    jm = JDSUNet(in_channels=4, out_channels=2, **TINY)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)),
                     jnp.zeros((1,)))["params"]
    params = random_flax_params(params, 5)
    pm = build_model("dsunet", device="cpu", in_channels=4, out_channels=2,
                     **TINY).eval()
    pm.load_state_dict(flax_to_state_dict(params, pm))
    cond = _x(8, (2, 16, 16, 3))
    c = torch.from_numpy(cond)

    def jden(x, t):
        return jm.apply({"params": params},
                        jnp.concatenate([x, jnp.asarray(cond)], -1), t)[0]

    def pden(x, t):
        return pm(torch.cat([x, c], -1), t)[0]

    return jden, pden


@pytest.mark.parametrize("name", ["ancestral", "dpm++", "plms", "reverse"])
def test_loops_with_a_tiny_dsunet_match_jax(tiny_model, name):
    jden, pden = tiny_model
    jsched, psched = _scheds(3)
    x = _x(9, (2, 16, 16, 1))
    kw = dict(parameterization="v", learn_sigma=True)
    rng = jax.random.PRNGKey(11)
    with torch.no_grad():
        if name == "reverse":
            want = JS.ddim_reverse_loop(jsched, jden, jnp.asarray(np.tanh(x)),
                                        **kw)
            got = PS.ddim_reverse_loop(psched, pden,
                                       torch.from_numpy(np.tanh(x)), **kw)
        elif name == "ancestral":
            want = JS.p_sample_loop(jsched, jden, jnp.asarray(x), rng,
                                    variance_type="fixed_large", **kw)
            got = PS.p_sample_loop(
                psched, pden, torch.from_numpy(x),
                variance_type="fixed_large",
                noise=_ancestral_noise(rng, 3, x.shape), **kw)
        else:
            want = JS.make_sampler(name)(jsched, jden, jnp.asarray(x), **kw)
            got = PS.make_sampler(name)(psched, pden, torch.from_numpy(x),
                                        **kw)
    want = np.asarray(want)
    atol = MODEL_ATOL[name] * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, atol=atol)
