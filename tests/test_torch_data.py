"""The port's data plane against the JAX package's, on the CPU: the same
synthetic H5 store read by both packages' ``BatchLoader`` gives the same
arrays, ``valid``, ``case`` and ``slice`` for epochs 0 and 1, with shuffle,
augmentation (cv2 rotate, flip) and the edge channel on and the padded
tail batch included; the port's npy case store and its stacked volume
cache give the same rows; the K-fold split, the NIfTI codec (each package reads the other's files) and
the entropy curriculum's batches from one numpy generator match. All
exact: the same numpy and cv2 calls on the same inputs."""
import numpy as np
import pytest

from dsdiff_tpu.data import curriculum as JC
from dsdiff_tpu.data import h5store as JH
from dsdiff_tpu.data import nifti as JN
from dsdiff_tpu.data import pipeline as JP
from dsdiff_tpu.data import synthetic as JS
from dsdiff_torch.data import curriculum as PC
from dsdiff_torch.data import h5store as PH
from dsdiff_torch.data import nifti as PN
from dsdiff_torch.data import npy_dataset as PNpy
from dsdiff_torch.data import pipeline as PP
from dsdiff_torch.data import synthetic as PS
from dsdiff_torch.data import transforms as PT

KEYS = ["A", "B", "C", "GT"]
HW = 24  # padded to 32 by the loader: the padding is exercised too


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("stores")
    JS.make_structured_dataset(root / "jax", n_cases=4, n_slices=3, hw=HW,
                               seed=0)
    PS.make_structured_dataset(root / "h5", n_cases=4, n_slices=3, hw=HW,
                               seed=0)
    PS.make_structured_dataset(root / "npy", n_cases=4, n_slices=3, hw=HW,
                               seed=0, store="npy")
    return root


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y) == {"image", "target", "valid", "case",
                                    "slice"}
        for k in ("image", "target", "valid"):
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        assert x["case"] == y["case"] and x["slice"] == y["slice"]


def test_synthetic_stores_are_written_alike(stores):
    split = f"images_tr_{HW}"
    assert PH.list_cases(stores / "h5" / split) == JH.list_cases(
        stores / "jax" / split)
    for case in JH.list_cases(stores / "jax" / split):
        paths = JH.case_slices(stores / "jax" / split / case)
        assert [p.name for p in paths] == [
            p.name for p in PH.case_slices(stores / "h5" / split / case)]
        stacks = {k: np.load(stores / "npy" / split / case / f"{k}.npy")
                  for k in KEYS}
        for p in paths:
            want = JH.read_slice(p, KEYS)
            got = PH.read_slice(stores / "h5" / split / case / p.name, KEYS)
            for k in KEYS:
                np.testing.assert_array_equal(got[k], want[k])
                np.testing.assert_array_equal(
                    stacks[k][JH.slice_index(p)], want[k])


@pytest.mark.parametrize("store", ["h5", "npy"])
def test_loader_batches_match_jax_for_two_epochs(stores, store):
    split = f"images_tr_{HW}"
    kw = dict(keys=KEYS, use_edge="sobel", augment=True, aug_prob=0.6)
    want_ds = JP.SliceDataset(stores / "jax", split, **kw)
    cls = PP.SliceDataset if store == "h5" else PNpy.NpyCaseDataset
    got_ds = cls(stores / store, split, **kw)
    assert got_ds.image_channels() == want_ds.image_channels() == 4
    # 9 slices in batches of 4: the third epoch batch is padded to full size
    for shuffle, drop_last in ((True, False), (True, True), (False, False)):
        want = JP.BatchLoader(want_ds, 4, seed=7, shuffle=shuffle,
                              drop_last=drop_last, process_count=1,
                              process_index=0)
        got = PP.BatchLoader(got_ds, 4, seed=7, shuffle=shuffle,
                             drop_last=drop_last)
        assert len(got) == len(want)
        for epoch in (0, 1):
            _same_batches(list(got.epoch(epoch)), list(want.epoch(epoch)))
        assert len(got.build_seconds) == len(got)
    batches = list(PP.BatchLoader(got_ds, 4, seed=7).epoch(1))
    assert batches[0]["image"].shape == (4, 32, 32, 4)
    tail = list(PP.BatchLoader(got_ds, 4, shuffle=False,
                               drop_last=False).epoch(0))[-1]
    assert tail["valid"].tolist() == [True, False, False, False]
    assert not tail["image"][1:].any()


def test_process_split_takes_rank_and_world_size(stores):
    ds = PP.SliceDataset(stores / "h5", f"images_tr_{HW}", keys=KEYS)
    full = list(PP.BatchLoader(ds, 4, seed=1).epoch(0))
    halves = [list(PP.BatchLoader(ds, 4, seed=1, process_count=2,
                                  process_index=r).epoch(0)) for r in (0, 1)]
    for b, h0, h1 in zip(full, *halves):
        np.testing.assert_array_equal(
            np.concatenate([h0["image"], h1["image"]]), b["image"])
    with pytest.raises(ValueError, match="divisible"):
        PP.BatchLoader(ds, 3, process_count=2)


def test_kfold_split_matches():
    cases = [f"case{i:03d}" for i in range(11)]
    for k, fold, seed in ((5, 1, 2024), (4, 0, 3), (2, 1, 0)):
        assert PH.kfold_split(cases, k, fold, seed) == JH.kfold_split(
            cases, k, fold, seed)
    assert PH.train_test_split_cases(cases, 0.3, 5) == \
        JH.train_test_split_cases(cases, 0.3, 5)


def test_nifti_round_trip_across_packages(tmp_path):
    rng = np.random.default_rng(2)
    affine = np.diag([0.8, 0.9, 2.5, 1.0])
    affine[:3, 3] = (-10.0, 4.0, 7.5)
    for dtype in (np.float32, np.int16, np.uint8):
        data = (rng.uniform(0, 200, (7, 5, 3))).astype(dtype)
        PN.write_nifti(tmp_path / "p.nii.gz", PN.Nifti(data, affine))
        JN.write_nifti(tmp_path / "j.nii", JN.Nifti(data, affine))
        for got in (JN.read_nifti(tmp_path / "p.nii.gz"),
                    PN.read_nifti(tmp_path / "j.nii"),
                    PN.read_nifti(tmp_path / "p.nii.gz")):
            assert got.data.dtype == dtype
            np.testing.assert_array_equal(got.data, data)
            np.testing.assert_allclose(got.affine, affine, rtol=1e-6)
        assert (tmp_path / "p.nii.gz").read_bytes() != b""
    like = PN.Nifti.like(np.zeros((7, 5, 3), np.float32),
                         PN.read_nifti(tmp_path / "p.nii.gz"))
    np.testing.assert_allclose(like.spacing, (0.8, 0.9, 2.5), rtol=1e-6)


def test_entropy_curriculum_batches_match(stores):
    split = f"images_tr_{HW}"
    jds = JP.SliceDataset(stores / "jax", split, keys=KEYS)
    pds = PP.SliceDataset(stores / "h5", split, keys=KEYS)
    jc, pc = JC.EntropyCurriculum(jds, seed=4), PC.EntropyCurriculum(pds, seed=4)
    assert pc.buckets == jc.buckets
    jr, pr = np.random.default_rng(9), np.random.default_rng(9)
    for step in (0, 3, 10):
        want = jc.batch(4, step, 10, jr)
        got = pc.batch(4, step, 10, pr)
        for k in ("image", "target", "valid"):
            np.testing.assert_array_equal(got[k], want[k])


def test_transforms_are_the_jax_packages():
    from dsdiff_tpu.data import transforms as JT

    rng = np.random.default_rng(3)
    for hw in (16, 17, 40):
        x = rng.uniform(-1, 1, (2, hw, hw + 3)).astype(np.float32)
        np.testing.assert_array_equal(PT.divisible_pad(x), JT.divisible_pad(x))
        for seed in range(4):
            got = PT.random_rotate([x, x[:1]], np.random.default_rng(seed),
                                   prob=1.0)
            want = JT.random_rotate([x, x[:1]], np.random.default_rng(seed),
                                    prob=1.0)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        for kind in ("sobel", "laplacian", "sobel&laplacian", "canny"):
            np.testing.assert_array_equal(
                PT.edge_map(x, kind, np.random.default_rng(1)),
                JT.edge_map(x, kind, np.random.default_rng(1)))
    v = rng.uniform(0, 900, (6, 6, 4)).astype(np.float32)
    np.testing.assert_array_equal(PT.normalize_minmax(v), JT.normalize_minmax(v))
    np.testing.assert_array_equal(PT.normalize_zscore(v), JT.normalize_zscore(v))


def test_volume_cache_rows_are_the_slice_store_rows(stores, tmp_path):
    split = f"images_tr_{HW}"
    paths = PNpy.build_volume_cache(stores / "h5", split, KEYS, tmp_path)
    stacked = PNpy.NpyVolumeDataset(paths, gt_key="GT", augment=True,
                                    use_edge="canny")
    rows = PP.SliceDataset(stores / "h5", split, keys=KEYS, augment=True,
                           use_edge="canny")
    assert len(stacked) == len(rows) == 9
    assert stacked.image_channels() == rows.image_channels() == 4
    for i in range(len(rows)):
        got = stacked.get(i, np.random.default_rng(i))
        want = rows.get(i, np.random.default_rng(i))
        for k in ("image", "target"):
            np.testing.assert_array_equal(got[k], want[k])
    window = PNpy.NpyVolumeDataset(paths, gt_key="GT", slice_range=(2, 5))
    assert len(window) == 3 and window.get(0, None)["slice"] == 2
