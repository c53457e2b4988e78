"""The whole DSUNet of the port against the Flax DSUNet: a narrow model
(C=32, channel_mult (1, 2), attention at rate 2 on 16², head channels 16,
in 4 / out 2, both stream layouts), the same seeded weights through the
bridge. The output and every ``features`` entry agree to 1e-4 absolute in
f32 (summation order differs between XLA and PyTorch)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.models.dsunet import DSUNet as JDSUNet
from dsdiff_torch.models import build_model
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict
from torch_parity_utils import one_thread, random_flax_params

pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 1e-4

TINY = dict(
    model_channels=32, num_res_blocks=1, attention_resolutions=(2,),
    channel_mult=(1, 2), num_head_channels=16, use_scale_shift_norm=True,
)


@pytest.mark.parametrize("in_ch, use_edge, atol", [
    (4, False, ATOL),
    (5, True, ATOL),
    # two zero-padded streams: their in_conv output is spatially constant,
    # and GroupNorm divides the rounding noise of such a map by sqrt(1e-6)
    (2, False, 2e-3),
])
def test_dsunet_output_and_features_match(in_ch, use_edge, atol):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16, in_ch)).astype(np.float32)
    t = np.array([3.0, 742.0], np.float32)
    jm = JDSUNet(in_channels=in_ch, out_channels=2, use_edge=use_edge, **TINY)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))
    params = random_flax_params(params["params"], 7)
    want_out, want_feats = jm.apply({"params": params}, jnp.asarray(x),
                                    jnp.asarray(t))

    pm = build_model("dsunet", device="cpu", in_channels=in_ch,
                     out_channels=2, use_edge=use_edge, **TINY).eval()
    pm.load_state_dict(flax_to_state_dict(params, pm))
    with torch.no_grad():
        got_out, got_feats = pm(torch.from_numpy(x), torch.from_numpy(t))

    assert got_out.dtype == torch.float32 and got_out.shape == (2, 16, 16, 2)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=atol)
    assert set(got_feats) == set(want_feats)
    for name, want in want_feats.items():
        got = got_feats[name].numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, np.asarray(want), atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("in_ch, use_edge", [(4, False), (5, True)])
def test_stacked_stream_layout_matches_jax(in_ch, use_edge):
    """``stream_mode='vmap'``: the parameters live under ``encoders`` with
    a leading [4] stream axis; under ``use_edge`` every stream's stem is two
    channels wide and the condition streams get a zero channel."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 16, in_ch)).astype(np.float32)
    t = np.array([3.0, 742.0], np.float32)
    jm = JDSUNet(in_channels=in_ch, out_channels=2, use_edge=use_edge,
                 stream_mode="vmap", **TINY)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))
    params = random_flax_params(params["params"], 8)
    want_out, want_feats = jm.apply({"params": params}, jnp.asarray(x),
                                    jnp.asarray(t))
    pm = build_model("dsunet", device="cpu", in_channels=in_ch,
                     out_channels=2, use_edge=use_edge, stream_mode="vmap",
                     **TINY).eval()
    assert pm.stacked_prefixes == ("encoders.",)
    assert pm.encoders.in_conv.weight.shape == (4, 32, 2 if use_edge else 1,
                                                3, 3)
    pm.load_state_dict(flax_to_state_dict(params, pm))
    with torch.no_grad():
        got_out, got_feats = pm(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=ATOL)
    assert set(got_feats) == set(want_feats)
    for name, want in want_feats.items():
        np.testing.assert_allclose(got_feats[name].numpy(), np.asarray(want),
                                   atol=ATOL, err_msg=name)


def test_dsunet_refuses_what_is_not_ported():
    with pytest.raises(ValueError, match="unknown stream_mode"):
        build_model("dsunet", device="cpu", stream_mode="grouped", **TINY)
    # fusion='crossattn' is ported (test_torch_transformer.py); an unknown
    # fusion is refused
    with pytest.raises(ValueError, match="unknown fusion 'sum'"):
        build_model("dsunet", device="cpu", fusion="sum", **TINY)
    with pytest.raises(ValueError, match="2-4 input channels"):
        build_model("dsunet", device="cpu", in_channels=6, **TINY)


def test_build_model_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("dsunet", **TINY)
