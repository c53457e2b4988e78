"""The port's checkpoint-file readers (``dsdiff_torch.utils.torch_io``)
against the JAX package's torch-free ones (``dsdiff_tpu.utils.torch_io``) on
the same files: a zip pickle, safetensors in F32 / F16 / BF16 / I64 with a
``__metadata__`` entry, the Lightning ``state_dict`` nesting and the legacy
(pre-1.6, non-zip) ``torch.save`` format. Values must be equal, dtypes as
the JAX reader gives them (f16 and bf16 made f32)."""
import ml_dtypes
import numpy as np
import pytest
import torch

from dsdiff_torch.utils import torch_io as P
from dsdiff_tpu.utils import torch_io as J
from torch_eval_weights import write_safetensors


def _state_dict(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {
        "conv.weight": torch.randn(4, 3, 3, 3, generator=gen),
        "norm.weight": torch.randn(4, generator=gen).half(),
        "proj.weight": torch.randn(5, 4, generator=gen).bfloat16(),
        "bn.num_batches_tracked": torch.tensor(7),
        "index": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "mask": torch.tensor([True, False, True]),
        # a strided view: the file holds its whole storage
        "view": torch.randn(6, 4, generator=gen)[:, 1:3],
    }


def _assert_same(got: dict, want: dict, names) -> None:
    assert sorted(got) == sorted(want) == sorted(names)
    for k, w in want.items():
        g = got[k]
        assert isinstance(g, torch.Tensor), k
        assert g.numpy().dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


@pytest.mark.parametrize("nesting", ["flat", "state_dict"])
def test_zip_pickle_matches_jax(tmp_path, nesting):
    sd = _state_dict()
    path = tmp_path / "w.pth"
    torch.save(sd if nesting == "flat" else
               {"state_dict": sd, "epoch": 3, "global_step": 11}, path)
    got, want = P.load_checkpoint(path), J.load_checkpoint(path)
    _assert_same(got, want, sd)
    assert got["norm.weight"].dtype == torch.float32
    assert got["bn.num_batches_tracked"].dtype == torch.int64
    assert got["mask"].dtype == torch.bool
    torch.testing.assert_close(got["proj.weight"], sd["proj.weight"].float(),
                               rtol=0, atol=0)
    torch.testing.assert_close(got["view"], sd["view"], rtol=0, atol=0)


def test_legacy_pickle_matches_jax(tmp_path):
    sd = _state_dict(1)
    path = tmp_path / "legacy.pt"
    torch.save({"state_dict": sd}, path, _use_new_zipfile_serialization=False)
    with open(path, "rb") as f:
        assert f.read(4) != b"PK\x03\x04"  # not a zip archive
    _assert_same(P.load_checkpoint(path), J.load_checkpoint(path), sd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.int64])
def test_safetensors_matches_jax(tmp_path, dtype):
    gen = torch.Generator().manual_seed(2)
    tensors = {"a.weight": (100 * torch.randn(3, 5, generator=gen)).to(dtype),
               "b.bias": (100 * torch.randn(7, generator=gen)).to(dtype),
               "empty": torch.zeros(0, 4, dtype=dtype)}
    path = tmp_path / "w.safetensors"
    write_safetensors(path, tensors, metadata={"format": "pt"})
    # the raw reader: the file's own dtype (bf16 natively)
    raw = P.load_safetensors(path)
    jraw = J.load_safetensors(path)
    assert sorted(raw) == sorted(jraw) == sorted(tensors)
    for k, t in tensors.items():
        assert raw[k].dtype == dtype
        assert torch.equal(raw[k], t), k
        want = jraw[k]
        if want.dtype == ml_dtypes.bfloat16:
            want = want.astype(np.float32)
        np.testing.assert_array_equal(raw[k].float().numpy()
                                      if dtype == torch.bfloat16
                                      else raw[k].numpy(), want)
    _assert_same(P.load_checkpoint(path), J.load_checkpoint(path), tensors)


def test_unreadable_file_raises(tmp_path):
    path = tmp_path / "junk.bin"
    path.write_bytes(b"\x00" * 64)
    with pytest.raises(Exception):
        P.load_checkpoint(path)
