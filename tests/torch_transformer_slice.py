"""The transformer conditioning path as a whole, shared by
``test_torch_crossattn_slice.py`` (``fusion: crossattn``) and
``test_torch_spatial_slice.py`` (``use_spatial_transformer: true``): the
flagship run config with that run's ``unet_config.params``, the JAX
package's ``Trainer`` and the port's on the same tiny config (a narrow
DSUNet at 16², f32, batch 2), the same seeded weights (every leaf random)
and JAX's draws replayed into the port:

- one train step given JAX's t and noise: every metric JAX reports to 1e-4
  relative (the port adds grad_norm), every parameter moved;
- ``sample_fn`` (DDIM-3 from the EMA weights) given JAX's x_T: 1e-4
  absolute.

A test module names its run in ``RUN`` and imports this module's fixture
and tests. The FFT form is held by ``test_torch_transformer.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.parallel import mesh as pmesh
from dsdiff_tpu.train import Trainer as JTrainer
from dsdiff_tpu.train import state as JState
from dsdiff_tpu.train.config import Config as JConfig
from dsdiff_torch.models.attention import FFTAttention, SpatialTransformer
from dsdiff_torch.train.trainer import Trainer
from torch_parity_utils import TINY, random_flax_params, tiny_cfg

RTOL = 1e-4
ATOL = 1e-4
B = 2
STEPS = 3
# each run's unet_config.params over the tiny flagship's
RUNS = {
    "crossattn": dict(TINY, num_heads=4, fusion="crossattn"),
    "spatial_transformer": dict(TINY, use_spatial_transformer=True),
}


def _batch(seed=31):
    rng = np.random.default_rng(seed)
    return {"target": rng.uniform(-1, 1, (B, 16, 16, 1)).astype(np.float32),
            "image": rng.standard_normal((B, 16, 16, 3)).astype(np.float32)}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def pair(request, tmp_path_factory):
    name = request.module.RUN
    cfg = tiny_cfg(STEPS)
    cfg.update(image_size=16, unet_config={"params": RUNS[name]})
    jt = JTrainer(JConfig.wrap(cfg), tmp_path_factory.mktemp(name),
                  mesh=pmesh.local_mesh())
    tree = random_flax_params(jt.state.params["params"], 17)
    jt.state = JState.TrainState.create(jt.model.apply, {"params": tree},
                                        jt.state.tx, ema_decay=0.9999)
    pt = Trainer(cfg, device="cpu")
    pt.load_flax_params({"params": tree})
    assert pt.n_params == sum(p.size for p in jax.tree.leaves(tree))
    yield name, jt, pt, tree
    jt.ckpt.close()


def test_the_config_builds_the_transformer_path(pair):
    name, _, pt, _ = pair
    model = pt.model
    transformers = [m for m in model.modules()
                    if isinstance(m, SpatialTransformer)]
    if name == "crossattn":
        assert transformers == [model.fusion_attn]
        assert model.fusion_attn.depth == 4
    else:
        # one an attention block: 4 encoders, the middle, the decoder
        assert len(transformers) == 4 + 1 + 2
        assert not any(isinstance(m, FFTAttention) for m in model.modules())


def test_train_step_matches_jax_given_its_draws(pair):
    name, jt, pt, tree = pair
    batch = _batch()
    start = {n: p.detach().clone() for n, p in pt.model.named_parameters()}
    rng = jax.random.PRNGKey(4)
    _, _, want = jt.train_step(jax.tree.map(jnp.copy, jt.state),
                               jt.sampler_state,
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               rng)
    t_rng, n_rng, _, _ = jax.random.split(jax.random.fold_in(rng, 0), 4)
    t = jax.random.randint(t_rng, (B,), 0, 1000)
    noise = jax.random.normal(n_rng, batch["target"].shape, jnp.float32)
    got = pt.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                        t=_t(t).long(), noise=_t(noise))
    frozen = [n for n, p in pt.model.named_parameters()
              if torch.equal(p, start[n])]
    pt.load_flax_params({"params": tree})  # back to the shared start
    assert set(got) == set(want) | {"grad_norm"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=f"{name} {k}")
    assert not frozen, frozen  # the fusion's to_k / to_v included


def test_sample_fn_matches_jax_given_its_x_T(pair):
    name, jt, pt, _ = pair
    cond = _batch(32)["image"]
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jt.sample_fn(jt.state.ema_params, jnp.asarray(cond),
                                   rng))
    x_T = jax.random.normal(jax.random.split(rng)[0], (B, 16, 16, 1),
                            jnp.float32)
    got = pt.sample_fn(torch.from_numpy(cond), x_T=_t(x_T))
    assert got.shape == want.shape == (B, 16, 16, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, err_msg=name)
