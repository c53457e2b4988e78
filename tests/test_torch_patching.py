"""Split-input (patched) sampling and the composite distance of the port
against the JAX package's, f32 on the CPU:

- ``delta_border``, ``get_weighting`` (float64 on the host in both):
  exact; ``extract_patches``, ``fold_patches`` and ``patched_apply`` (a
  tile function that mixes each tile's pixels, with channel conditioning):
  1e-6; a fold that leaves pixels uncovered raises as the JAX package's;
- a patched DDIM-3 request through the flagship ``Trainer`` (tiny DSUNet at
  16², ``split_input_params`` ks 8, stride 4: 9 tiles a slice in one model
  call, the model's features dropped) against the JAX ``Trainer``'s, given
  its x_T: 1e-4 absolute, the tolerance of the other request tests;
- ``composite_distance`` with every term: 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.core import composite_loss as JC
from dsdiff_tpu.core import patching as JP
from dsdiff_tpu.parallel import mesh as pmesh
from dsdiff_tpu.train import Trainer as JTrainer
from dsdiff_tpu.train import state as JState
from dsdiff_tpu.train.config import Config as JConfig
from dsdiff_torch.core import composite_loss as PC
from dsdiff_torch.core import patching as PP
from dsdiff_torch.train.trainer import Trainer
from torch_parity_utils import one_thread, random_flax_params, tiny_cfg

pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 1e-6
REQUEST_ATOL = 1e-4
SPLIT = {"ks": [8, 8], "stride": [4, 4]}


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("h, w", [(5, 5), (8, 6), (1, 4)])
def test_delta_border_and_weighting_are_the_jax_package_s(h, w):
    np.testing.assert_array_equal(PP.delta_border(h, w),
                                  JP.delta_border(h, w))
    for kw in ({}, {"tie_braker": False},
               {"clip_min_weight": 0.1, "clip_max_tie_weight": 0.3}):
        np.testing.assert_array_equal(PP.get_weighting(h, w, 3, 2, **kw),
                                      JP.get_weighting(h, w, 3, 2, **kw))


def test_extract_and_fold_patches_match_jax():
    x = _x(0, 2, 16, 12, 3)
    want = JP.extract_patches(jnp.asarray(x), (8, 4), (4, 4))
    got = PP.extract_patches(torch.from_numpy(x), (8, 4), (4, 4))
    assert got.shape == (2, 9, 8, 4, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    patches = _x(1, 2, 9, 8, 4, 3)
    weighting = JP.get_weighting(8, 4, 3, 3)
    want = JP.fold_patches(jnp.asarray(patches), (16, 12), (8, 4), (4, 4),
                           weighting)
    got = PP.fold_patches(torch.from_numpy(patches), (16, 12), (8, 4),
                          (4, 4), weighting)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_patched_apply_with_conditioning_matches_jax():
    """A tile function that is not pointwise (each output pixel reads its
    tile's mean and its time), so the tiles' borders and the weighting
    show; one call over every tile of every batch element."""
    x, cond = _x(2, 2, 16, 16, 1), _x(3, 2, 16, 16, 2)
    t = np.array([3.0, 500.0], np.float32)
    calls = []

    def fn(lib):
        def tile_fn(tiles, t_tiles):
            calls.append(tiles.shape)
            mean = tiles.mean(axis=(1, 2), keepdims=True) if lib is jnp \
                else tiles.mean(dim=(1, 2), keepdim=True)
            out = lib.tanh(tiles[..., :1] * mean[..., 1:2] + mean[..., 2:])
            return out + 0.001 * t_tiles.reshape(-1, 1, 1, 1)
        return tile_fn

    want = JP.patched_apply(fn(jnp), jnp.asarray(x), jnp.asarray(t), (8, 8),
                            (4, 4), cond=jnp.asarray(cond))
    got = PP.patched_apply(fn(torch), torch.from_numpy(x), torch.from_numpy(t),
                           (8, 8), (4, 4), cond=torch.from_numpy(cond))
    assert calls == [(18, 8, 8, 3)] * 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_fold_refuses_tiles_that_leave_pixels_uncovered():
    patches = torch.zeros(1, 4, 8, 8, 1)
    with pytest.raises(ValueError, match="do not tile the H extent"):
        PP.fold_patches(patches, (17, 16), (8, 8), (8, 8),
                        JP.get_weighting(8, 8, 2, 2))
    with pytest.raises(ValueError, match="do not tile the W extent"):
        PP.patched_apply(lambda x, t: x, torch.zeros(1, 16, 18, 1),
                         torch.zeros(1), (8, 8), (4, 4))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    cfg = tiny_cfg(3)
    cfg.update(image_size=16, split_input_params=SPLIT)
    jt = JTrainer(JConfig.wrap(cfg), tmp_path_factory.mktemp("patched"),
                  mesh=pmesh.local_mesh())
    params = random_flax_params(jt.state.params["params"], 21)
    jt.state = JState.TrainState.create(jt.model.apply, {"params": params},
                                        jt.state.tx, ema_decay=0.9999)
    pt = Trainer(cfg, device="cpu")
    pt.load_flax_params({"params": params})
    yield jt, pt
    jt.ckpt.close()


def test_patched_ddim_request_matches_jax_given_its_x_T(pair):
    jt, pt = pair
    cond = _x(4, 2, 16, 16, 3)
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jt.sample_fn(jt.state.ema_params, jnp.asarray(cond),
                                   rng))
    x_T = np.array(jax.random.normal(jax.random.split(rng)[0],
                                     (2, 16, 16, 1), jnp.float32))
    calls = []
    hook = pt.sample_model.register_forward_hook(
        lambda m, args, out: calls.append(tuple(args[0].shape)))
    try:
        got = pt.sample_fn(torch.from_numpy(cond), x_T=torch.from_numpy(x_T))
    finally:
        hook.remove()
    assert calls == [(18, 8, 8, 4)] * 3  # one call over 2 x 9 tiles a step
    assert got.shape == want.shape == (2, 16, 16, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=REQUEST_ATOL)
    # the tiles' seams: a patched chain is not the unpatched one
    pt.cfg["split_input_params"] = None
    pt.set_sampler("ddim")
    try:
        whole = pt.sample_fn(torch.from_numpy(cond),
                             x_T=torch.from_numpy(x_T))
    finally:
        pt.cfg["split_input_params"] = SPLIT
        pt.set_sampler("ddim")
    assert (whole - got).abs().max() > 1e-3


@pytest.mark.parametrize("weights", [
    {"l1": 1.0},
    {"l2": 0.5, "ssim": 0.3},
    {"l1": 0.2, "l2": 0.1, "ssim": 0.4, "ms_ssim": 0.3, "perceptual": 0.7},
])
def test_composite_distance_matches_jax(weights):
    """Every term on 2 x 176² maps (MS-SSIM's five levels need 161 pixels
    and more); the perceptual term a plain mean-square of the pair."""
    pred = np.tanh(_x(6, 2, 176, 176, 1))
    target = np.tanh(pred + 0.3 * _x(7, 2, 176, 176, 1))
    want = JC.composite_distance(
        weights, perceptual_fn=lambda p, t: jnp.mean((p - t) ** 2, (1, 2, 3)))(
        jnp.asarray(pred), jnp.asarray(target))
    got = PC.composite_distance(
        weights, perceptual_fn=lambda p, t: ((p - t) ** 2).mean((1, 2, 3)))(
        torch.from_numpy(pred), torch.from_numpy(target))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
