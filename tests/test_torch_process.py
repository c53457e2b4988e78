"""dsdiff_torch.core.process / sampling tables against dsdiff_tpu, in f32 on
the CPU. The math is elementwise over identical tables, so 1e-6 absolute
(a few f32 ulps at the values' magnitude) is the tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.core import process as JP
from dsdiff_tpu.core import sampling as JS
from dsdiff_tpu.core import schedules as JSch
from dsdiff_torch.core import process as PP
from dsdiff_torch.core import sampling as PS
from dsdiff_torch.core import schedules as PSch

ATOL = 1e-6


def _scheds(steps="20"):
    betas = JSch.make_beta_schedule("scaled_linear", 1000)
    use = JSch.space_timesteps(1000, steps)
    return JSch.respace(betas, use), PSch.respace(betas, use, device="cpu")


def _inputs(seed, B=3, C=1):
    rng = np.random.default_rng(seed)
    xt = rng.standard_normal((B, 8, 8, C)).astype(np.float32)
    out = rng.standard_normal((B, 8, 8, 2 * C)).astype(np.float32) * 1.5
    t = np.array([0, 7, 19][:B], np.int64)
    return xt, out, t


@pytest.mark.parametrize("parameterization", ["v", "eps", "x0"])
def test_p_mean_variance_learned_sigma(parameterization):
    js, ps = _scheds()
    xt, out, t = _inputs(0)
    jr = JP.p_mean_variance(js, jnp.asarray(out), jnp.asarray(xt),
                            jnp.asarray(t, jnp.int32), parameterization,
                            learn_sigma=True, clip_denoised=True)
    pr = PP.p_mean_variance(ps, torch.from_numpy(out), torch.from_numpy(xt),
                            torch.from_numpy(t), parameterization,
                            learn_sigma=True, clip_denoised=True)
    for field in JP.PMeanVariance._fields:
        np.testing.assert_allclose(
            getattr(pr, field).numpy(), np.asarray(getattr(jr, field)),
            rtol=1e-5, atol=ATOL, err_msg=field,
        )


@pytest.mark.parametrize("variance_type", ["fixed_small", "fixed_large"])
def test_p_mean_variance_fixed_variance(variance_type):
    js, ps = _scheds()
    xt, out, t = _inputs(1)
    out = out[..., :1]
    jr = JP.p_mean_variance(js, jnp.asarray(out), jnp.asarray(xt),
                            jnp.asarray(t, jnp.int32), "v",
                            variance_type=variance_type)
    pr = PP.p_mean_variance(ps, torch.from_numpy(out), torch.from_numpy(xt),
                            torch.from_numpy(t), "v",
                            variance_type=variance_type)
    for field in JP.PMeanVariance._fields:
        np.testing.assert_allclose(
            getattr(pr, field).numpy(), np.asarray(getattr(jr, field)),
            rtol=1e-5, atol=ATOL, err_msg=field,
        )


def test_q_sample_and_timestep_map():
    js, ps = _scheds()
    rng = np.random.default_rng(2)
    x0 = rng.standard_normal((3, 4, 4, 1)).astype(np.float32)
    noise = rng.standard_normal((3, 4, 4, 1)).astype(np.float32)
    t = np.array([0, 5, 19], np.int64)
    jq = JP.q_sample(js, jnp.asarray(x0), jnp.asarray(t, jnp.int32),
                     jnp.asarray(noise))
    pq = PP.q_sample(ps, torch.from_numpy(x0), torch.from_numpy(t),
                     torch.from_numpy(noise))
    np.testing.assert_allclose(pq.numpy(), np.asarray(jq), atol=ATOL)
    np.testing.assert_array_equal(
        PP.model_timestep(ps, torch.from_numpy(t)).numpy(),
        np.asarray(JP.model_timestep(js, jnp.asarray(t, jnp.int32))),
    )


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_tables_match(eta):
    js, ps = _scheds()
    for jt, pt in zip(JS._ddim_tables(js, eta), PS._ddim_tables(ps, eta)):
        np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))


def test_cfg_wrap_matches():
    rng = np.random.default_rng(4)
    c, u, x = (rng.standard_normal((2, 4, 4, 1)).astype(np.float32)
               for _ in range(3))
    want = JS.cfg_wrap(lambda x, t: jnp.asarray(c) * x,
                       lambda x, t: jnp.asarray(u) + t[:, None, None, None],
                       3.0)(jnp.asarray(x), jnp.asarray([1.0, 2.0]))
    got = PS.cfg_wrap(lambda x, t: torch.from_numpy(c) * x,
                      lambda x, t: torch.from_numpy(u) + t[:, None, None, None],
                      3.0)(torch.from_numpy(x), torch.tensor([1.0, 2.0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _train_inputs(seed, B=3):
    rng = np.random.default_rng(seed)
    x0 = np.clip(rng.standard_normal((B, 8, 8, 1)), -1, 1).astype(np.float32)
    noise = rng.standard_normal((B, 8, 8, 1)).astype(np.float32)
    out = rng.standard_normal((B, 8, 8, 2)).astype(np.float32)
    t = np.array([0, 1, 999][:B], np.int64)
    return x0, noise, out, t


def _full_scheds():
    betas = JSch.make_beta_schedule("scaled_linear", 1000)
    return (JSch.DiffusionSchedule.create(betas),
            PSch.DiffusionSchedule.create(betas, device="cpu"))


def test_get_v_and_q_mean_variance():
    js, ps = _full_scheds()
    x0, noise, _, t = _train_inputs(5)
    jt = jnp.asarray(t, jnp.int32)
    np.testing.assert_allclose(
        PP.get_v(ps, torch.from_numpy(x0), torch.from_numpy(noise),
                 torch.from_numpy(t)).numpy(),
        np.asarray(JP.get_v(js, jnp.asarray(x0), jnp.asarray(noise), jt)),
        atol=ATOL,
    )
    for got, want in zip(PP.q_mean_variance(ps, torch.from_numpy(x0),
                                            torch.from_numpy(t)),
                         JP.q_mean_variance(js, jnp.asarray(x0), jt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=ATOL)


def test_vb_terms_bpd_covers_the_decoder_nll_and_the_kl():
    js, ps = _full_scheds()
    x0, noise, out, t = _train_inputs(6)
    jt = jnp.asarray(t, jnp.int32)
    xt = np.asarray(JP.q_sample(js, jnp.asarray(x0), jt, jnp.asarray(noise)))
    jvb, jx0 = JP.vb_terms_bpd(js, jnp.asarray(out), jnp.asarray(x0),
                               jnp.asarray(xt), jt, "v", learn_sigma=True)
    pvb, px0 = PP.vb_terms_bpd(ps, torch.from_numpy(out), torch.from_numpy(x0),
                               torch.from_numpy(xt), torch.from_numpy(t), "v",
                               learn_sigma=True)
    np.testing.assert_allclose(pvb.numpy(), np.asarray(jvb), rtol=1e-5,
                               atol=ATOL)
    np.testing.assert_allclose(px0.numpy(), np.asarray(jx0), atol=ATOL)


@pytest.mark.parametrize("loss_type, learn_sigma, param, elbo", [
    ("charbonnier", True, "v", 0.0),
    ("l2", False, "eps", 0.5),
    ("l1", True, "x0", 0.0),
])
def test_training_losses_match(loss_type, learn_sigma, param, elbo):
    js, ps = _full_scheds()
    x0, noise, out, t = _train_inputs(7)
    jt = jnp.asarray(t, jnp.int32)
    # a prediction near its target keeps the t=0 decoder likelihood away
    # from its 1e-12 clip, where f32 tanh rounding alone decides the value
    target = {"eps": noise, "x0": x0,
              "v": np.asarray(JP.get_v(js, jnp.asarray(x0),
                                       jnp.asarray(noise), jt))}[param]
    pred = target + 1e-3 * out[..., :1]
    if learn_sigma:
        pred = np.concatenate([pred, out[..., 1:]], axis=-1)

    def jmodel(x, tm):
        return jnp.asarray(pred) + 0.0 * x

    def pmodel(x, tm):
        return torch.from_numpy(pred) + 0.0 * x

    jterms, _ = JP.training_losses(
        js, jmodel, jnp.asarray(x0), jt, jnp.asarray(noise),
        parameterization=param, loss_type=loss_type, learn_sigma=learn_sigma,
        elbo_weight=elbo,
    )
    pterms, _ = PP.training_losses(
        ps, pmodel, torch.from_numpy(x0), torch.from_numpy(t),
        torch.from_numpy(noise), parameterization=param, loss_type=loss_type,
        learn_sigma=learn_sigma, elbo_weight=elbo,
    )
    assert set(pterms) == set(jterms)
    for k in jterms:
        np.testing.assert_allclose(pterms[k].numpy(), np.asarray(jterms[k]),
                                   rtol=1e-5, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(PP.lvlb_weights(ps, param).numpy(),
                               np.asarray(JP.lvlb_weights(js, param)),
                               rtol=1e-5)


def test_vb_term_gives_no_gradient_to_the_mean_half():
    js, ps = _full_scheds()
    x0, noise, out, t = _train_inputs(8)
    raw = torch.from_numpy(out).requires_grad_()
    terms, _ = PP.training_losses(
        ps, lambda x, tm: raw, torch.from_numpy(x0), torch.from_numpy(t),
        torch.from_numpy(noise), learn_sigma=True,
    )
    (g_vb,) = torch.autograd.grad(terms["vb"].sum(), raw, retain_graph=True)
    assert torch.all(g_vb[..., :1] == 0)
    assert torch.any(g_vb[..., 1:] != 0)
    (g_mse,) = torch.autograd.grad(terms["mse"].sum(), raw)
    assert torch.all(g_mse[..., 1:] == 0) and torch.any(g_mse[..., :1] != 0)
