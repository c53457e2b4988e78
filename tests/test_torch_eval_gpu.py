"""The evaluation networks and the chain timer on the card, against the
same calls on the CPU, with TF32 off (``utils.device.full_f32``).

Every test is marked ``gpu`` and skips without a card. No JAX is imported,
so on the card's machine they run with
``python -m pytest --noconftest -m gpu tests/test_torch_eval_gpu.py``.
"""
import numpy as np
import pytest
import torch

from dsdiff_torch.eval import fid as PF
from dsdiff_torch.eval import perceptual as PP
from dsdiff_torch.utils import benchtime as PB
from dsdiff_torch.utils.device import full_f32
from torch_eval_weights import (random_inception_state_dict,
                                random_resnet50_state_dict)

RTOL = 1e-4  # of the CPU result's largest magnitude


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.gpu
def test_inception_extractor_on_card_matches_cpu(tmp_path):
    _need_card()
    path = tmp_path / "inception.pth"
    torch.save(random_inception_state_dict(), path)
    x = _images((4, 256, 256, 1), 0)
    with full_f32():
        got = PF.make_inception_extractor(path, device="cuda")(x)
    want = PF.make_inception_extractor(path, device="cpu")(x)
    assert got.shape == want.shape == (4, 2048)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * float(np.abs(want).max()))


@pytest.mark.gpu
def test_rad_perceptual_and_fake_3d_on_card_match_cpu(tmp_path):
    _need_card()
    path = tmp_path / "resnet50.pth"
    torch.save(random_resnet50_state_dict(), path)
    x = torch.from_numpy(_images((2, 64, 64, 16), 1))
    y = torch.clamp(x + 0.3 * torch.from_numpy(_images((2, 64, 64, 16), 2)),
                    -1, 1)
    cpu = PP.load_resnet50_perceptual(path, device="cpu")
    card = PP.load_resnet50_perceptual(path, device="cuda")
    with full_f32():
        got = PP.fake_3d_distance(card, x.cuda(), y.cuda(), ratio=0.5,
                                  seed=1).cpu()
    want = PP.fake_3d_distance(cpu, x, y, ratio=0.5, seed=1)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=0)


@pytest.mark.gpu
def test_chain_time_on_card():
    _need_card()
    x0 = torch.randn(512, 512, device="cuda")
    per_call = PB.chain_time(lambda x: torch.tanh(x @ x), x0, length=8)
    assert np.isfinite(per_call) and 0 < per_call < 1.0
