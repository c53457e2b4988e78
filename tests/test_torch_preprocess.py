"""The port's offline preprocessing (``data.preprocess``,
``data.nnunet_export``, ``cli.preprocess``) against the JAX package's on a
synthetic NIfTI dataset the test writes: the same H5 slice store (files,
arrays, ``train_test.csv``), the same BraTS crop, the same nnU-Net raw
tree and ``dataset.json``, exactly."""
import json
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

from dsdiff_tpu.data import nnunet_export as JN
from dsdiff_tpu.data import preprocess as JP
from dsdiff_torch.data import nnunet_export as PN
from dsdiff_torch.data import preprocess as PP
from dsdiff_torch.data.nifti import Nifti, read_nifti, write_nifti

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("F_Data1", "S_Data2")
CASES = [f"case_{i:02d}" for i in range(5)]
TARGET = 16


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """<case>/<key>.nii.gz volumes of 20 x 24 x 3 voxels (one case stores
    one key uncompressed), a 1.2 x 0.9 x 3 mm grid."""
    root = tmp_path_factory.mktemp("nifti_src")
    rng = np.random.default_rng(0)
    affine = np.diag([1.2, 0.9, 3.0, 1.0])
    for i, case in enumerate(CASES):
        (root / case).mkdir()
        for key in KEYS:
            vol = rng.gamma(2.0, 50.0, (20, 24, 3)).astype(np.float32)
            name = f"{key}.nii" if (i, key) == (1, "S_Data2") else \
                f"{key}.nii.gz"
            write_nifti(root / case / name, Nifti(vol, affine))
    return root


def _tree(root: Path) -> dict:
    """{relative path: file} of every file under ``root``."""
    return {p.relative_to(root).as_posix(): p
            for p in sorted(root.rglob("*")) if p.is_file()}


def _assert_same_store(got: Path, want: Path):
    g, w = _tree(got), _tree(want)
    assert list(g) == list(w) and any(k.endswith(".h5") for k in g)
    for rel, path in w.items():
        if rel.endswith(".h5"):
            with h5py.File(path, "r") as fw, h5py.File(g[rel], "r") as fg:
                assert sorted(fg) == sorted(fw) == sorted(KEYS), rel
                for k in fw:
                    np.testing.assert_array_equal(fg[k][()], fw[k][()],
                                                  err_msg=f"{rel} {k}")
                    assert fg[k].dtype == fw[k].dtype
        else:
            assert g[rel].read_bytes() == path.read_bytes(), rel


@pytest.mark.parametrize("norm", ["minmax", "zscore"])
def test_preprocess_dataset_writes_the_jax_store(dataset, tmp_path, norm):
    want = JP.preprocess_dataset(dataset, tmp_path / "jax", keys=KEYS,
                                 target=TARGET, norm=norm)
    got = PP.preprocess_dataset(dataset, tmp_path / "port", keys=KEYS,
                                target=TARGET, norm=norm)
    assert got == want and len(got[1]) == 2
    _assert_same_store(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("is_mask", [False, True])
def test_resample_and_normalize_equal_jax(dataset, is_mask):
    vol = read_nifti(dataset / CASES[0] / f"{KEYS[0]}.nii.gz")
    if is_mask:
        vol = Nifti((vol.data > 100).astype(np.uint8), vol.affine)
    want = JP.resample_inplane(vol, TARGET, is_mask=is_mask)
    got = PP.resample_inplane(vol, TARGET, is_mask=is_mask)
    assert got.data.shape == (TARGET, TARGET, 3)
    assert got.data.dtype == want.data.dtype
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.affine, want.affine)
    with pytest.raises(ValueError, match="unknown normalization"):
        PP.normalize_volume(got.data, "percentile")


def test_crop_brats_equals_jax(dataset):
    vols = {k: read_nifti(dataset / CASES[2] / f"{k}.nii.gz") for k in KEYS}
    seg = np.zeros((20, 24, 3), np.uint8)
    seg[4:9, 6:12, 1:3] = 2
    vols["seg"] = Nifti(seg, vols[KEYS[0]].affine)
    want = JP.crop_brats(vols, inplane=12)
    got = PP.crop_brats(vols, inplane=12)
    assert set(got) == set(want) == {*KEYS, "seg"}
    for k in want:
        assert got[k].data.shape == (12, 12, 2)
        np.testing.assert_array_equal(got[k].data, want[k].data, err_msg=k)
        np.testing.assert_array_equal(got[k].affine, want[k].affine)


def test_export_nnunet_raw_equals_jax(dataset, tmp_path):
    volumes = {c: dataset / c / f"{KEYS[0]}.nii.gz" for c in CASES[:3]}
    labels = {c: dataset / c / f"{KEYS[1]}.nii.gz" for c in CASES[::2]}
    want = JN.export_nnunet_raw(volumes, tmp_path / "jax", labels=labels)
    got = PN.export_nnunet_raw(volumes, tmp_path / "port", labels=labels)
    assert got.name == want.name == "Task500_synth"
    g, w = _tree(got), _tree(want)
    assert list(g) == list(w) and "dataset.json" in g
    for rel in w:
        assert g[rel].read_bytes() == w[rel].read_bytes(), rel
    meta = json.loads(g["dataset.json"].read_text())
    assert meta["numTraining"] == 3 and "label" not in meta["training"][1]


def test_preprocess_cli_runs(dataset, tmp_path):
    JP.preprocess_dataset(dataset, tmp_path / "jax", keys=KEYS, target=TARGET,
                          test_frac=0.4, seed=7)
    out = subprocess.run(
        [sys.executable, "-m", "dsdiff_torch.cli.preprocess", "--src",
         str(dataset), "--dst", str(tmp_path / "port"), "--keys", *KEYS,
         "--target", str(TARGET), "--test_frac", "0.4", "--seed", "7"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "3 train / 2 test cases" in out.stdout
    _assert_same_store(tmp_path / "port", tmp_path / "jax")
