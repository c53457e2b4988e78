"""The port's DiT (``net_mode: dit``) against the Flax DiT: narrow models
(hidden 64 or 128, depth 2, 32² input) at head dims 16 and 64, the same
seeded weights through the bridge, every leaf random (adaLN and the final
head included, which start at zero). The output agrees to 1e-4 absolute in
f32; with class labels, the training forward's label dropout is given as a
mask, drawn in JAX from the dropout key."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.models.dit import DiT as JDiT
from dsdiff_tpu.models.dit import _sincos_2d_pos_embed as j_pos
from dsdiff_torch.models import build_model
from dsdiff_torch.models.dit import DIT_CONFIGS, _sincos_2d_pos_embed
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict, random_params
from torch_parity_utils import one_thread, random_flax_params

pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 1e-4


def _pair(seed, **kw):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    t = np.array([7.0, 901.0], np.float32)
    jm = JDiT(input_size=32, in_channels=3, out_channels=2, depth=2, **kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                     jnp.zeros((2,), jnp.int32))
    params = random_flax_params(params["params"], seed)
    pm = build_model("dit", device="cpu", input_size=32, in_channels=3,
                     out_channels=2, depth=2, **kw)
    pm.load_state_dict(flax_to_state_dict(params, pm))
    return jm, params, pm, x, t


@pytest.mark.parametrize("kw", [
    dict(patch_size=8, hidden_size=64, num_heads=4),    # head dim 16
    dict(patch_size=4, hidden_size=128, num_heads=2),   # head dim 64
])
def test_dit_matches_jax(kw):
    jm, params, pm, x, t = _pair(13, **kw)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == (2, 32, 32, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_dit_label_dropout_with_a_given_mask_matches_jax():
    """JAX's training forward replaces the dropped labels by the null class
    ``num_classes`` (its mask drawn from the dropout key): it equals the
    deterministic forward on one of the four masks' labels. The port's
    training forward given a mask equals JAX's deterministic forward on
    that mask's labels, and differs from the forward that keeps them."""
    kw = dict(patch_size=8, hidden_size=64, num_heads=4, num_classes=5,
              class_dropout_prob=0.5)
    jm, params, pm, x, t = _pair(14, **kw)
    y = np.array([2, 4], np.int32)

    def jax_on(labels):
        return np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                                   jnp.asarray(t), jnp.asarray(labels)))

    masks = [np.array(m) for m in ([0, 0], [0, 1], [1, 0], [1, 1])]
    drawn = np.asarray(jm.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y),
        deterministic=False, rngs={"dropout": jax.random.PRNGKey(3)}))
    assert any(np.abs(drawn - jax_on(np.where(m, 5, y))).max() < 1e-6
               for m in masks)

    drop = np.array([True, False])
    want = jax_on(np.where(drop, 5, y))
    with torch.no_grad():
        got = pm.train()(torch.from_numpy(x), torch.from_numpy(t),
                         torch.from_numpy(y).long(),
                         drop=torch.from_numpy(drop))
        kept = pm.eval()(torch.from_numpy(x), torch.from_numpy(t),
                         torch.from_numpy(y).long())
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(kept.numpy(), jax_on(y), atol=ATOL)
    assert (got - kept).abs().max() > 1e-3


def test_dit_draws_label_dropout_from_the_bound_generator():
    from dsdiff_torch.models.layers import dropout_generator

    pm = build_model("dit", device="cpu", input_size=32, patch_size=8,
                     hidden_size=64, num_heads=4, depth=1, num_classes=5,
                     class_dropout_prob=0.5).train()
    y = torch.tensor([1, 2, 3, 4] * 8)
    with pytest.raises(RuntimeError, match="generator"):
        pm.label_drop_mask(y)
    gen = torch.Generator().manual_seed(0)
    with dropout_generator(pm, gen):
        drop = pm.label_drop_mask(y)
    want = torch.rand(32, generator=torch.Generator().manual_seed(0)) < 0.5
    assert torch.equal(drop, want) and pm.generator is None


def test_pos_embed_and_registry_match_jax():
    np.testing.assert_array_equal(_sincos_2d_pos_embed(96, 5), j_pos(96, 5))
    pm = build_model("dit_s_8", device="cpu", input_size=32)
    assert pm.depth == 12 and pm.block_0.heads == 6
    assert DIT_CONFIGS["DiT_XL_2"]["hidden_size"] // 16 == 72


def test_random_params_fills_the_zero_initialised_heads():
    pm = build_model("dit", device="cpu", input_size=32, patch_size=8,
                     hidden_size=64, num_heads=4, depth=1)
    for name in ("block_0.adaLN.weight", "final_adaLN.weight",
                 "final_proj.weight"):
        assert not pm.get_parameter(name).any(), name
    random_params(pm, 0)
    for name in ("block_0.adaLN.weight", "final_adaLN.weight",
                 "final_proj.weight"):
        assert pm.get_parameter(name).abs().min() > 0, name
    with torch.no_grad():
        out = pm.eval()(torch.randn(1, 32, 32, 1), torch.tensor([3.0]))
    assert out.abs().max() > 0
