"""The port's 3-D, RGB and whole-body presets (``data.transforms``) against
the JAX package's: the same sample and the same ``np.random.Generator``
seed give the same arrays, exactly, whether the random augmentations fire
or not."""
import numpy as np
import pytest

from dsdiff_tpu.data import transforms as JT
from dsdiff_torch.data import transforms as PT

PRESETS = [
    ("get_3d_train_transform", 3, True),
    ("get_3d_val_transform", 3, False),
    ("get_2d_rgb_train_transform", 2, True),
    ("get_2d_rgb_val_transform", 2, False),
    ("get_wholebody_test_transform", 3, False),
]


def _sample(dims: int, seed: int) -> dict:
    shape = (7, 13, 11) if dims == 3 else (21, 19)
    rng = np.random.default_rng(seed)
    return {
        "A": rng.normal(size=shape).astype(np.float32),
        "B": rng.normal(size=shape).astype(np.float32),
        "t1ce": rng.normal(size=shape).astype(np.float32),
        "mask": (rng.random(shape) > 0.5).astype(np.float32),
    }


@pytest.mark.parametrize("name, dims, train", PRESETS)
def test_preset_equals_jax_from_the_same_seed(name, dims, train):
    kw = {"random_prob": 0.5} if train else {}
    want_fn = getattr(JT, name)(["A", "B"], **kw)
    got_fn = getattr(PT, name)(["A", "B"], **kw)
    for seed in range(4):  # the draws fire on some seeds and not others
        sample = _sample(dims, 10 + seed)
        want = want_fn(sample, np.random.default_rng(seed))
        got = got_fn(sample, np.random.default_rng(seed))
        assert set(got) == set(want) == {"image", "t1ce", "mask"}
        for k in want:
            assert got[k].dtype == want[k].dtype, (name, seed, k)
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{name} {seed} {k}")


@pytest.mark.parametrize("arrays_ndim", [3, 4])
def test_random_rotate_3d_and_flips_equal_jax(arrays_ndim):
    rng = np.random.default_rng(5)
    arrays = [rng.normal(size=(2, 6, 9, 8) if arrays_ndim == 4
                         else (6, 9, 8)).astype(np.float32)
              for _ in range(2)]
    want = JT.random_rotate_3d(arrays, np.random.default_rng(1), prob=1.0)
    got = PT.random_rotate_3d(arrays, np.random.default_rng(1), prob=1.0)
    assert not np.array_equal(got[0], arrays[0])  # it rotated
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    want = JT._random_flip_nd(arrays, np.random.default_rng(2), 0.5,
                              (-3, -2, -1))
    got = PT._random_flip_nd(arrays, np.random.default_rng(2), 0.5,
                             (-3, -2, -1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
