"""The port's UNet (``net_mode`` ddpm and palette) against the Flax UNet: a
narrow model (C=32, channel_mult (1, 2), attention at rate 2 on 16², in 4 /
out 2), the same seeded weights through the bridge, every leaf random. The
output agrees to 1e-4 absolute in f32, plain, with a class label embedding
and with the adm vector path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.models.unet import UNet as JUNet
from dsdiff_torch.models import build_model
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict
from torch_parity_utils import one_thread, random_flax_params

pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 1e-4

TINY = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2,),
            channel_mult=(1, 2), use_scale_shift_norm=True)


@pytest.mark.parametrize("extra, y", [
    (dict(num_head_channels=16), None),
    (dict(num_heads=2, num_classes=5), np.array([3, 0])),
    (dict(num_heads=4, use_scale_shift_norm=False, adm_in_channels=6,
          resblock_updown=True),
     np.random.default_rng(9).standard_normal((2, 6)).astype(np.float32)),
])
def test_unet_matches_jax(extra, y):
    kw = dict(TINY, **extra)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([3.0, 742.0], np.float32)
    jm = JUNet(in_channels=4, out_channels=2, **kw)
    jy = None if y is None else jnp.asarray(y)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                     y=jy)
    params = random_flax_params(params["params"], 11)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), y=jy)

    pm = build_model("unet", device="cpu", in_channels=4, out_channels=2,
                     **kw).eval()
    pm.load_state_dict(flax_to_state_dict(params, pm))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(t),
                 y=None if y is None else torch.from_numpy(y))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_unet_refuses_what_is_not_ported():
    # spatial transformers are ported (test_torch_transformer.py): built
    # with a context width, a context of another width is refused
    pm = build_model("unet", device="cpu", use_spatial_transformer=True,
                     context_dim=8, **TINY)
    with pytest.raises(RuntimeError, match="shapes cannot be multiplied"):
        pm(torch.zeros(1, 16, 16, 1), torch.zeros(1), torch.zeros(1, 3, 6))
    pm = build_model("unet", device="cpu", num_classes=3, **TINY)
    with pytest.raises(ValueError, match="needs y"):
        pm(torch.zeros(1, 16, 16, 1), torch.zeros(1))
