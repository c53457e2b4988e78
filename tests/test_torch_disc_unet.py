"""The port's DiscUNet (``net_mode: disc_diff``) against the Flax DiscUNet:
a narrow model (C=32, channel_mult (1, 2), attention at rate 2 on 16², 4
streams, out 2) in both stream layouts, the same seeded weights through the
bridge, every leaf random. The output and both feature groups (common,
distinct) agree to 1e-4 absolute in f32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.models.disc_unet import DiscUNet as JDiscUNet
from dsdiff_torch.models import build_model
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict, random_params
from torch_parity_utils import one_thread, random_flax_params

pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 1e-4

TINY = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2,),
            channel_mult=(1, 2), num_heads=2)


@pytest.mark.parametrize("stream_mode, n", [("sequential", 4), ("vmap", 4),
                                            ("sequential", 3)])
def test_disc_unet_output_and_features_match(stream_mode, n):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 16, n)).astype(np.float32)
    t = np.array([5.0, 611.0], np.float32)
    jm = JDiscUNet(n_streams=n, out_channels=2, stream_mode=stream_mode,
                   **TINY)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))
    params = random_flax_params(params["params"], 12)
    want_out, want_feats = jm.apply({"params": params}, jnp.asarray(x),
                                    jnp.asarray(t))

    pm = build_model("disc_unet", device="cpu", n_streams=n, out_channels=2,
                     stream_mode=stream_mode, **TINY).eval()
    if stream_mode == "vmap":
        assert pm.stacked_prefixes == ("encoders.",)
        assert pm.encoders.in_conv.weight.shape == (n, 32, 1, 3, 3)
    pm.load_state_dict(flax_to_state_dict(params, pm))
    with torch.no_grad():
        got_out, got_feats = pm(torch.from_numpy(x), torch.from_numpy(t))
    assert got_out.dtype == torch.float32 and got_out.shape == (2, 16, 16, 2)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=ATOL)
    assert set(got_feats) == set(want_feats) == {"common", "distinct"}
    for name, want in want_feats.items():
        got = got_feats[name].numpy()
        assert got.shape == want.shape == (n, 2, 8, 8, 32), name
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL,
                                   err_msg=name)


def test_random_params_fills_the_zero_initialised_out_head():
    """The out head starts at zero; random_params gives it weights, so the
    output depends on the whole model (each stream's slice of the stacked
    layout filled by the same rules)."""
    pm = build_model("disc_unet", device="cpu", stream_mode="vmap", **TINY)
    assert not pm.out.conv.weight.any()
    random_params(pm, 0)
    assert pm.out.conv.weight.abs().min() > 0
    x = torch.randn(1, 16, 16, 4)
    with torch.no_grad():
        out, _ = pm.eval()(x, torch.tensor([10.0]))
    assert out.abs().max() > 0


def test_disc_unet_refuses_a_wrong_stream_count():
    pm = build_model("disc_unet", device="cpu", n_streams=4, **TINY)
    with pytest.raises(ValueError, match="expects 4 channels"):
        pm(torch.zeros(1, 16, 16, 3), torch.zeros(1))
    with pytest.raises(ValueError, match="unknown stream_mode"):
        build_model("disc_unet", device="cpu", stream_mode="grouped", **TINY)


def test_disc_disentangle_loss_matches_jax():
    """The com/dist ratio over [n, B, h, w, c] features, n = 4 and 3."""
    from dsdiff_tpu.core import losses as JL
    from dsdiff_torch.core import losses as PL

    rng = np.random.default_rng(10)
    for n in (4, 3):
        feats = {k: rng.standard_normal((n, 2, 4, 4, 8)).astype(np.float32)
                 for k in ("common", "distinct")}
        want = JL.disc_disentangle_loss(
            {k: jnp.asarray(v) for k, v in feats.items()})
        got = PL.disc_disentangle_loss(
            {k: torch.from_numpy(v) for k, v in feats.items()})
        np.testing.assert_allclose(got.item(), float(want), atol=1e-5,
                                   rtol=1e-5)
