"""``DSUNetSplit`` of the port against the Flax ``DSUNetSplit``: a narrow
model (C=32, channel_mult (1, 2), attention at rate 2 on 16², head channels
16, out 2), the same seeded weights through the bridge, both stream layouts,
with and without the edge channel and ``cond_t_ref``. Outputs, features and
the condition cache agree to 1e-4 absolute in f32 (summation order differs
between XLA and PyTorch). Within the port, ``denoise_cached`` and ``forward``
run the same operations on the same values where they must agree, so they
are held to 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.models import dsunet_cached as JC
from dsdiff_torch.models import build_model, make_cached_denoiser
from dsdiff_torch.utils.flax_bridge import (
    flax_to_state_dict,
    random_params,
    train_state_from_flax,
)
from torch_parity_utils import TINY, one_thread, random_flax_params

pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 1e-4
SAME_OPS_ATOL = 1e-6
T = np.array([3.0, 742.0], np.float32)


def _pair(stream_mode="sequential", use_edge=False, cond_t_ref=None, seed=7):
    """(Flax model, its params, the port's model with the same weights)."""
    in_ch = 5 if use_edge else 4
    kw = dict(in_channels=in_ch, out_channels=2, stream_mode=stream_mode,
              use_edge=use_edge, cond_t_ref=cond_t_ref, **TINY)
    jm = JC.DSUNetSplit(dtype=jnp.float32, **kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, in_ch)),
                     jnp.zeros((1,)))["params"]
    params = random_flax_params(params, seed)
    pm = build_model("dsunet_split", device="cpu", dtype=torch.float32,
                     **kw).eval()
    pm.load_state_dict(flax_to_state_dict(params, pm))
    return jm, params, pm


def _x(seed, ch):
    return np.random.default_rng(seed).standard_normal(
        (2, 16, 16, ch)).astype(np.float32)


def _assert_features(got, want, atol=ATOL):
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=atol, err_msg=name)


def _nhwc(t):
    """The port's [..., C, H, W] cache entry as the Flax [..., H, W, C]."""
    return t.movedim(-3, -1).numpy()


CASES = [
    ("sequential", False, None),
    ("sequential", True, 500.0),
    ("vmap", False, 500.0),
    ("vmap", True, None),
]


@pytest.mark.parametrize("stream_mode, use_edge, cond_t_ref", CASES)
def test_forward_matches_jax(stream_mode, use_edge, cond_t_ref):
    jm, params, pm = _pair(stream_mode, use_edge, cond_t_ref)
    x = _x(3, 5 if use_edge else 4)
    want_out, want_feats = jm.apply({"params": params}, jnp.asarray(x),
                                    jnp.asarray(T))
    with torch.no_grad():
        got_out, got_feats = pm(torch.from_numpy(x), torch.from_numpy(T))
    assert got_out.dtype == torch.float32 and got_out.shape == (2, 16, 16, 2)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=ATOL)
    _assert_features(got_feats, want_feats)


@pytest.mark.parametrize("stream_mode, use_edge, cond_t_ref", CASES)
def test_cache_and_cached_step_match_jax(stream_mode, use_edge, cond_t_ref):
    jm, params, pm = _pair(stream_mode, use_edge, cond_t_ref)
    cond = _x(4, 3)
    x_noise = _x(5, 2 if use_edge else 1)
    t_ref = np.full((2,), 321.0, np.float32)
    want_cache = jm.apply({"params": params}, jnp.asarray(cond),
                          jnp.asarray(t_ref),
                          method=JC.DSUNetSplit.encode_conditions)
    want_out, want_feats = jm.apply(
        {"params": params}, jnp.asarray(x_noise), jnp.asarray(T), want_cache,
        method=JC.DSUNetSplit.denoise_cached)
    with torch.no_grad():
        h_cond, skips = pm.encode_conditions(torch.from_numpy(cond),
                                             torch.from_numpy(t_ref))
        got_out, got_feats = pm.denoise_cached(
            torch.from_numpy(x_noise), torch.from_numpy(T), (h_cond, skips))
    np.testing.assert_allclose(_nhwc(h_cond), np.asarray(want_cache[0]),
                               atol=ATOL)
    assert len(skips) == len(want_cache[1])
    for got, want in zip(skips, want_cache[1]):
        assert got.shape[0] == 3
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=ATOL)
    _assert_features(got_feats, want_feats)


@pytest.mark.parametrize("stream_mode, use_edge", [("sequential", False),
                                                   ("vmap", True)])
def test_cached_equals_full_where_it_must(stream_mode, use_edge):
    """With ``cond_t_ref`` the cached step IS the full forward at any t and
    any ``t_ref`` handed in; without it only where t == t_ref."""
    x = torch.from_numpy(_x(6, 5 if use_edge else 4))
    t = torch.from_numpy(T)
    cond = x[..., 1:4]
    x_noise = torch.cat([x[..., 0:1], x[..., 4:5]], -1) if use_edge \
        else x[..., 0:1]

    def both(pm, t_ref):
        with torch.no_grad():
            full, full_feats = pm(x, t)
            cached, cached_feats = pm.denoise_cached(
                x_noise, t, pm.encode_conditions(cond, t_ref))
        return full, full_feats, cached, cached_feats

    _, _, pinned = _pair(stream_mode, use_edge, cond_t_ref=500.0)
    full, ff, cached, cf = both(pinned, torch.full((2,), 77.0))
    np.testing.assert_allclose(cached.numpy(), full.numpy(),
                               atol=SAME_OPS_ATOL)
    _assert_features(cf, ff, SAME_OPS_ATOL)

    _, _, free = _pair(stream_mode, use_edge, cond_t_ref=None)
    full, ff, cached, cf = both(free, t)
    np.testing.assert_allclose(cached.numpy(), full.numpy(),
                               atol=SAME_OPS_ATOL)
    _assert_features(cf, ff, SAME_OPS_ATOL)
    full, _, cached, _ = both(free, torch.full((2,), 500.0))
    assert (cached - full).abs().max() > 1e-3  # an approximation there


@pytest.mark.parametrize("use_edge", [False, True])
def test_make_cached_denoiser_matches_jax(use_edge):
    jm, params, pm = _pair("sequential", use_edge)
    cond = _x(8, 4 if use_edge else 3)
    x = _x(9, 1)
    want = JC.make_cached_denoiser(jm, {"params": params}, jnp.asarray(cond))(
        jnp.asarray(x), jnp.asarray(T))
    denoise = make_cached_denoiser(pm, torch.from_numpy(cond))
    with torch.no_grad():
        got = denoise(torch.from_numpy(x), torch.from_numpy(T))
    assert got.shape == (2, 16, 16, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("stream_mode", ["sequential", "vmap"])
def test_skip_sums_kept_across_steps_change_no_bit(stream_mode):
    """``sum_cond_skips`` once a request, as ``make_cached_denoiser`` does,
    gives bit for bit the step that sums inside ``denoise_cached``."""
    _, _, pm = _pair(stream_mode)
    x_noise, t = torch.from_numpy(_x(11, 1)), torch.from_numpy(T)
    with torch.no_grad():
        cache = pm.encode_conditions(torch.from_numpy(_x(10, 3)), t)
        sums = pm.sum_cond_skips(cache)
        want, want_feats = pm.denoise_cached(x_noise, t, cache)
        got, got_feats = pm.denoise_cached(x_noise, t, cache, sums)
    assert len(sums) == len(cache[1])
    assert all(s.shape == c.shape[1:] for s, c in zip(sums, cache[1]))
    assert torch.equal(got, want)
    assert all(torch.equal(got_feats[k], want_feats[k]) for k in want_feats)


def test_split_module_names_are_the_flax_tree():
    _, params, pm = _pair("sequential")
    assert pm.stacked_prefixes == ()
    tops = {k.split(".")[0] for k in pm.state_dict()}
    assert tops == set(params)
    assert {"noise_encoder", "cond_encoder_0", "cond_encoder_1",
            "cond_encoder_2", "middle", "all_proj", "decoder", "out"} <= tops
    _, vparams, vm = _pair("vmap")
    assert {k.split(".")[0] for k in vm.state_dict()} == set(vparams)
    w = vm.cond_encoders.down_0_0_res.in_conv.weight
    assert w.shape == (3, 32, 32, 3, 3)
    assert vm.stacked_prefixes == ("cond_encoders.",)


def test_bridge_refuses_a_tree_of_the_other_layout_or_a_wrong_shape():
    _, params, _ = _pair("sequential")
    _, vparams, vm = _pair("vmap")
    with pytest.raises(KeyError, match="missing .*unused"):
        flax_to_state_dict(params, vm)
    short = dict(vparams, cond_encoders=jax.tree_util.tree_map(
        lambda a: a[:2], vparams["cond_encoders"]))
    with pytest.raises(ValueError, match="does not fit"):
        flax_to_state_dict(short, vm)
    flat = dict(vparams, cond_encoders=jax.tree_util.tree_map(
        lambda a: a[0], vparams["cond_encoders"]))
    with pytest.raises(ValueError, match="rank|does not fit"):
        flax_to_state_dict(flat, vm)


def test_train_state_from_flax_takes_the_stacked_layout():
    _, vparams, vm = _pair("vmap")
    tree = {"params": vparams, "ema_params": vparams, "mu": vparams,
            "nu": vparams, "count": 3, "step": 3}
    out = train_state_from_flax(tree, vm)
    assert set(out["params"]) == set(vm.state_dict())
    key = "cond_encoders.in_conv.weight"
    assert out["mu"][key].shape == vm.state_dict()[key].shape == (3, 32, 1, 3, 3)


def test_random_params_fills_each_stream_of_a_stacked_layout():
    _, _, vm = _pair("vmap")
    random_params(vm, 0)
    sd = vm.state_dict()
    conv = sd["cond_encoders.down_0_0_res.in_conv.weight"]  # [3, 32, 32, 3, 3]
    assert not torch.equal(conv[0], conv[1])
    # N(0, 1/fan_in) with fan_in = 32 * 9, stream by stream
    for s in range(3):
        assert conv[s].std().item() == pytest.approx((32 * 9) ** -0.5, rel=0.1)
    scale = sd["cond_encoders.down_0_0_res.in_norm.norm.weight"]  # [3, 32]
    assert scale.shape == (3, 32) and abs(scale.mean().item() - 1.0) < 0.1
    bias = sd["cond_encoders.down_0_0_res.in_conv.bias"]
    assert bias.shape == (3, 32) and bias.std().item() < 0.2
    # the zero-initialised output layers are filled too
    assert sd["cond_encoders.down_0_0_res.out_conv.weight"].abs().sum() > 0
