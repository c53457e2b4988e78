"""dsdiff_torch.models.layers / attention against the Flax blocks, f32 on
the CPU, the same seeded weights through the layout bridge. Tolerance
1e-4 absolute: convolutions and matmuls sum in another order in XLA and
in PyTorch, at activations of order 1-10."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.models import attention as JA
from dsdiff_tpu.models import layers as JL
from dsdiff_torch.models import attention as PA
from dsdiff_torch.models import layers as PL
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict
from torch_parity_utils import nchw_to_nhwc, nhwc_to_nchw, random_flax_params

ATOL = 1e-4


def _port(flax_module, args, torch_module, seed=0):
    """Init the Flax module, randomise its params, load them into the torch
    module; returns the Flax params."""
    params = flax_module.init(jax.random.PRNGKey(0), *args)["params"]
    params = random_flax_params(params, seed)
    torch_module.load_state_dict(flax_to_state_dict(params, torch_module))
    return {"params": params}


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32
    )


def test_timestep_embedding_matches():
    # arguments reach 999 rad, where one f32 ulp is 6e-5: XLA's and
    # PyTorch's exp and sin differ by an ulp or two there
    t = np.array([0.0, 1.0, 17.0, 999.0], np.float32)
    for dim in (32, 33, 384):
        want = JL.timestep_embedding(jnp.asarray(t), dim)
        got = PL.timestep_embedding(torch.from_numpy(t), dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_group_norm32_eps_is_flax_default():
    assert PL.GroupNorm32.EPS == 1e-6
    gn = PL.GroupNorm32(48)
    assert gn.norm.eps == 1e-6 and gn.norm.num_groups == 24  # 32 does not divide 48
    # at a variance near eps, 1e-5 and 1e-6 give visibly different outputs
    x = _x((2, 4, 4, 48), scale=3e-3)
    params = _port(JL.GroupNorm32(), (jnp.asarray(x),), gn)
    want = JL.GroupNorm32().apply(params, jnp.asarray(x))
    got = nchw_to_nhwc(gn(nhwc_to_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize(
    "scale_shift, out_ch, up, down, conv_skip",
    [
        (True, 64, False, False, False),   # scale-shift FiLM, 1x1 skip
        (False, 64, False, False, True),   # additive FiLM, 3x3 skip
        (True, 32, True, False, False),    # up inside the block
        (False, 32, False, True, False),   # down inside the block
    ],
)
def test_resblock_matches(scale_shift, out_ch, up, down, conv_skip):
    x = _x((2, 8, 8, 32))
    emb = _x((2, 64), seed=2)
    jm = JL.ResBlock(out_channels=out_ch, use_scale_shift_norm=scale_shift,
                     up=up, down=down, use_conv_skip=conv_skip)
    pm = PL.ResBlock(32, 64, out_ch, use_scale_shift_norm=scale_shift,
                     up=up, down=down, use_conv_skip=conv_skip).eval()
    params = _port(jm, (jnp.asarray(x), jnp.asarray(emb)), pm)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(emb))
    got = nchw_to_nhwc(pm(nhwc_to_nchw(x), torch.from_numpy(emb)))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("heads, head_channels", [(1, 16), (8, -1)])
def test_attention_block_matches(heads, head_channels):
    x = _x((2, 8, 8, 64))
    jm = JA.AttentionBlock(num_heads=heads, num_head_channels=head_channels)
    pm = PA.AttentionBlock(64, heads, head_channels)
    params = _port(jm, (jnp.asarray(x),), pm)
    want = jm.apply(params, jnp.asarray(x))
    got = nchw_to_nhwc(pm(nhwc_to_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_se_block_and_resample_match():
    x = _x((2, 8, 8, 32))
    for jm, pm in [
        (JL.SEBlock(reduction=8), PL.SEBlock(32, reduction=8)),
        (JL.Upsample(), PL.Upsample(32)),
        (JL.Downsample(), PL.Downsample(32)),
    ]:
        params = _port(jm, (jnp.asarray(x),), pm)
        want = jm.apply(params, jnp.asarray(x))
        got = nchw_to_nhwc(pm(nhwc_to_nchw(x)))
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_bridge_refuses_a_tree_that_does_not_fit():
    pm = PL.SEBlock(32, reduction=8)
    params = random_flax_params(
        JL.SEBlock(reduction=8).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 32)))["params"], 0
    )
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="unused"):
        flax_to_state_dict(extra, pm)
    missing = {"fc1": params["fc1"]}
    with pytest.raises(KeyError, match="missing"):
        flax_to_state_dict(missing, pm)
    wrong = dict(params, fc1={"kernel": np.zeros((32, 5), np.float32)})
    with pytest.raises(ValueError, match="does not fit"):
        flax_to_state_dict(wrong, pm)
