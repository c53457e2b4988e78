"""ResBlock dropout above 0 in the port: the JAX package's ``ResBlock``
(``nn.Dropout`` with the ``dropout`` rng) and the port's, the same seeded
weights and inputs and the same keep mask (read off the Flax ``nn.Dropout``
call by ``flax.linen.intercept_methods``), agree to 1e-4 absolute, f32 on
the CPU (convolution sums in another order). The train step draws the
masks from its generator: two steps from one seed are equal bit for bit,
another seed gives other masks, and no generator raises."""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.models import layers as JL
from dsdiff_torch.models import layers as PL
from dsdiff_torch.train.trainer import Trainer
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict
from torch_parity_utils import (TINY, nchw_to_nhwc, nhwc_to_nchw, one_thread,
                                random_flax_params, tiny_cfg)

pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 1e-4
RATE = 0.3


def _jax_with_mask(jm, params, x, emb, key):
    """The Flax block's output and the keep mask its nn.Dropout drew."""
    seen = []

    def grab(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, nn.Dropout):
            seen.append((np.asarray(args[0]), np.asarray(out)))
        return out

    with nn.intercept_methods(grab):
        out = jm.apply(params, x, emb, rngs={"dropout": key})
    (h, dropped), = seen
    assert np.all(h != 0)  # so that a zero out means a dropped element
    return np.asarray(out), dropped != 0


@pytest.mark.parametrize("scale_shift, out_ch, down", [
    (True, 64, False), (False, 32, True)])
def test_resblock_dropout_matches_jax_given_its_mask(scale_shift, out_ch, down):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    emb = rng.standard_normal((2, 64)).astype(np.float32)
    jm = JL.ResBlock(out_channels=out_ch, use_scale_shift_norm=scale_shift,
                     down=down, dropout=RATE, deterministic=False)
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "dropout": jax.random.PRNGKey(1)},
                     jnp.asarray(x), jnp.asarray(emb))["params"]
    params = random_flax_params(params, 3)
    want, keep = _jax_with_mask(jm, {"params": params}, jnp.asarray(x),
                                jnp.asarray(emb), jax.random.PRNGKey(7))
    assert 0.5 < keep.mean() < 0.9  # about 1 - RATE kept
    pm = PL.ResBlock(32, 64, out_ch, dropout=RATE,
                     use_scale_shift_norm=scale_shift, down=down).train()
    pm.load_state_dict(flax_to_state_dict(params, pm))
    mask = torch.from_numpy(np.ascontiguousarray(keep.transpose(0, 3, 1, 2)))
    got = nchw_to_nhwc(pm(nhwc_to_nchw(x), torch.from_numpy(emb), mask))
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the same block without dropout is another function
    assert np.abs(got - nchw_to_nhwc(pm.eval()(nhwc_to_nchw(x),
                                                torch.from_numpy(emb)))).max() > 0.1


def test_train_steps_draw_dropout_from_the_step_generator():
    cfg = tiny_cfg()
    cfg["unet_config"] = {"params": dict(TINY, dropout=RATE)}
    rng = np.random.default_rng(1)
    batch = {"target": torch.from_numpy(
                 rng.uniform(-1, 1, (2, 16, 16, 1)).astype(np.float32)),
             "image": torch.from_numpy(
                 rng.standard_normal((2, 16, 16, 3)).astype(np.float32))}

    def run(seed):
        tr = Trainer(cfg, device="cpu")
        torch.manual_seed(seed + 100)  # the global generator plays no part
        out = [tr.train_step(batch, torch.Generator().manual_seed(seed))
               for _ in range(2)]
        return out, [p.detach().clone() for p in tr.state.params]

    (m_a, p_a), (m_b, p_b), (m_c, _) = run(5), run(5), run(6)
    for a, b in zip(m_a, m_b):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(p_a, p_b))
    assert float(m_a[1]["loss"]) != float(m_c[1]["loss"])
    tr = Trainer(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="generator"):
        tr.train_step(batch, t=torch.tensor([3, 500]),
                      noise=torch.zeros(2, 16, 16, 1))
