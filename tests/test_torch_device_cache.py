"""The device data cache (``dsdiff_torch.data.device_cache``) against the JAX
package's ``data/device_cache.py``, given JAX's draws, f32 on the CPU:
``_rotate_one`` and ``_augment_pair`` (borders and ±30° included) and a
whole batch of ``make_batch_fn`` within ``ATOL``: both sample the image at
the same f32 source coordinates, which ``grid_sample`` turns into
normalised coordinates and back, moving a sample point by up to ~1e-6
pixel. The 8 GiB cap and bf16 storage behave as JAX's; ``Trainer.fit``
with ``device_data_cache`` runs ``len(train_loader)`` steps an epoch on
batches from the cache, and refuses the shannon curriculum."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.data import device_cache as JDC
from dsdiff_tpu.data import synthetic as JSyn
from dsdiff_tpu.data.pipeline import SliceDataset as JSliceDataset
from dsdiff_torch.data import device_cache as DC
from dsdiff_torch.data.pipeline import SliceDataset
from dsdiff_torch.train.trainer import Trainer
from torch_parity_utils import one_thread, tiny_cfg

pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 1e-5
KEYS = ["A", "B", "C", "GT"]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("dcache")
    JSyn.make_structured_dataset(root, n_cases=3, n_slices=2, hw=16, seed=0)
    return root


def _datasets(store):
    common = dict(root=store, split="images_tr_16", keys=KEYS)
    return JSliceDataset(augment=False, **common), SliceDataset(
        augment=False, **common)


def _image(seed=5, hw=(24, 20), c=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, hw + (c,)).astype(np.float32)


@pytest.mark.parametrize("degrees", [-30.0, -17.0, 0.0, 11.5, 30.0])
def test_rotate_one_matches_jax(degrees):
    img = _image()
    angle = np.float32(np.deg2rad(degrees))
    want = np.asarray(JDC._rotate_one(jnp.asarray(img), jnp.asarray(angle)))
    got = DC._rotate_one(torch.from_numpy(img), angle).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)  # borders too


def _jax_pair_draws(key, aug_prob, max_deg=30.0):
    """The draws ``_augment_pair`` makes from ``key``."""
    k_rot, k_angle, k_f0, k_f1 = jax.random.split(key, 4)
    angle = jax.random.uniform(k_angle, minval=-max_deg,
                               maxval=max_deg) * jnp.pi / 180.0
    return (bool(jax.random.uniform(k_rot) < aug_prob), np.float32(angle),
            bool(jax.random.uniform(k_f0) < aug_prob),
            bool(jax.random.uniform(k_f1) < aug_prob))


@pytest.mark.parametrize("seed", range(6))
def test_augment_pair_matches_jax(seed):
    image, target = _image(seed), _image(seed + 100, c=1)
    key = jax.random.PRNGKey(seed)
    want = JDC._augment_pair(jnp.asarray(image), jnp.asarray(target), key,
                             0.6, 30.0)
    draws = _jax_pair_draws(key, 0.6)
    got = DC._augment_pair(torch.from_numpy(image), torch.from_numpy(target),
                           *draws)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


def _jax_batch_draws(key, batch, n, aug_prob):
    """The ``CacheDraws`` of JAX's ``make_batch_fn`` sample at ``key``."""
    k_idx, k_aug = jax.random.split(key)
    idx = np.asarray(jax.random.randint(k_idx, (batch,), 0, n))
    pairs = [_jax_pair_draws(k, aug_prob)
             for k in jax.random.split(k_aug, batch)]
    do_rot, angle, f0, f1 = (np.array(v) for v in zip(*pairs))
    return DC.CacheDraws(torch.from_numpy(idx.astype(np.int64)),
                         torch.from_numpy(do_rot), torch.from_numpy(angle),
                         torch.from_numpy(f0), torch.from_numpy(f1))


@pytest.mark.parametrize("augment", [True, False])
def test_batch_given_jax_draws_matches_jax_sample(store, augment):
    jds, pds = _datasets(store)
    jcache = JDC.DeviceCache.from_dataset(jds)
    cache = DC.DeviceCache.from_dataset(pds, device="cpu")
    assert cache.n == jcache.n == len(pds)
    key = jax.random.PRNGKey(7)
    want = jcache.make_batch_fn(6, augment=augment, aug_prob=0.7)(key)
    draws = _jax_batch_draws(key, 6, cache.n, 0.7)
    if augment:
        assert draws.do_rot.any() and not draws.do_rot.all()
    got = cache.batch(draws, augment=augment)
    plain = cache.plain_batch(draws, augment=augment)
    for k in ("image", "target"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), plain[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
    assert got["valid"].all() and got["valid"].shape == (6,)
    # a rank's rows of the same global batch
    rows = cache.batch(draws.rows(2, 4), augment=augment)
    assert torch.equal(rows["image"], got["image"][2:4])


def test_cap_and_bf16_storage_as_jax(store):
    jds, pds = _datasets(store)
    f32 = DC.DeviceCache.from_dataset(pds, device="cpu")
    nbytes = f32.images.numel() * 4 + f32.targets.numel() * 4
    for cap in (1, nbytes // 2 - 1):
        with pytest.raises(ValueError, match="GB on device"):
            JDC.DeviceCache.from_dataset(jds, dtype=jnp.bfloat16,
                                         max_bytes=cap)
        with pytest.raises(ValueError, match="GB on device"):
            DC.DeviceCache.from_dataset(pds, device="cpu",
                                        dtype=torch.bfloat16, max_bytes=cap)
    with pytest.raises(ValueError, match="GB on device"):
        DC.DeviceCache.from_dataset(pds, device="cpu", max_bytes=nbytes - 1)
    bf16 = DC.DeviceCache.from_dataset(pds, device="cpu",
                                       dtype=torch.bfloat16,
                                       max_bytes=nbytes // 2)
    jbf16 = JDC.DeviceCache.from_dataset(jds, dtype=jnp.bfloat16)
    assert bf16.images.dtype == torch.bfloat16
    key = jax.random.PRNGKey(2)
    want = jbf16.make_batch_fn(4, augment=False)(key)
    got = bf16.batch(_jax_batch_draws(key, 4, bf16.n, 0.4), augment=False)
    np.testing.assert_array_equal(got["image"].numpy(),
                                  np.asarray(want["image"]))


def test_make_batch_fn_draws_from_a_generator(store):
    _, pds = _datasets(store)
    cache = DC.DeviceCache.from_dataset(pds, device="cpu")
    fn = cache.make_batch_fn(8, aug_prob=0.9)
    a = fn(torch.Generator().manual_seed(3))
    b = fn(torch.Generator().manual_seed(3))
    c = fn(torch.Generator().manual_seed(4))
    assert torch.equal(a["image"], b["image"])
    assert not torch.equal(a["image"], c["image"])
    part = fn(torch.Generator().manual_seed(3), rows=(4, 8))
    assert torch.equal(part["image"], a["image"][4:])


def _fit_cfg(store, **more):
    cfg = tiny_cfg(2)
    cfg.update(h5_2d_img_dir=str(store), image_size=16, train_keys=KEYS,
               train_batch_size=2, val_batch_size=2, fold_K=3, fold_idx=0,
               limit_val_batches=1, log_images=False, device_data_cache=True,
               **more)
    return cfg


def test_fit_with_the_cache_runs_loader_windows(store, tmp_path):
    trainer = Trainer(_fit_cfg(store), tmp_path / "run", device="cpu")
    n = len(trainer.train_loader)
    assert n >= 1
    seen = []
    step = trainer.train_step

    def spy(batch, generator=None):
        seen.append(batch["image"])
        return step(batch, generator)

    trainer.train_step = spy
    loader_epoch = trainer.train_loader.epoch
    trainer.train_loader.epoch = lambda e: pytest.fail("host loader used")
    assert trainer.fit(num_epochs=2, log_every=1, val_every_epochs=5) == 2 * n
    trainer.train_loader.epoch = loader_epoch
    assert len(seen) == 2 * n
    assert all(b.shape == (2, 32, 32, 3) and b.dtype == torch.float32
               for b in seen)
    assert not torch.equal(seen[0], seen[1])
    rows = [r for r in (tmp_path / "run" / "logs" / "progress.jsonl"
                        ).read_text().splitlines() if '"epoch"' in r]
    assert len(rows) == 2 * n


def test_fit_with_the_cache_refuses_shannon(store, tmp_path):
    trainer = Trainer(_fit_cfg(store, shannon=True), tmp_path / "run",
                      device="cpu")
    with pytest.raises(ValueError, match="shannon"):
        trainer.fit(num_epochs=1)
