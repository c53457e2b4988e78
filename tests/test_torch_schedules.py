"""dsdiff_torch.core.schedules against dsdiff_tpu.core.schedules.

Both packages build the tables in float64 numpy and store float32, so the
tables must agree to 1e-7 (in practice bit for bit).
"""
import numpy as np
import pytest

from dsdiff_tpu.core import schedules as J
from dsdiff_torch.core import schedules as P

ATOL = 1e-7


def _assert_same(js, ps):
    for field in J.DiffusionSchedule._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(ps, field).cpu()),
            np.asarray(getattr(js, field)), rtol=0, atol=ATOL, err_msg=field,
        )
    assert ps.num_timesteps == js.num_timesteps


@pytest.mark.parametrize("name", ["scaled_linear", "linear", "cosine",
                                  "sqrt_linear"])
def test_full_tables_match(name):
    betas = J.make_beta_schedule(name, 1000)
    np.testing.assert_array_equal(P.make_beta_schedule(name, 1000), betas)
    _assert_same(J.DiffusionSchedule.create(betas),
                 P.DiffusionSchedule.create(betas, device="cpu"))


@pytest.mark.parametrize("sections", ["20", "ddim50", "10,15,25"])
def test_respaced_tables_match(sections):
    betas = J.make_beta_schedule("scaled_linear", 1000)
    use = J.space_timesteps(1000, sections)
    assert P.space_timesteps(1000, sections) == use
    _assert_same(J.respace(betas, use), P.respace(betas, use, device="cpu"))


def test_rescaled_and_short_schedules_match():
    betas = J.make_beta_schedule("scaled_linear", 10)  # clamped at max_beta
    np.testing.assert_array_equal(P.make_beta_schedule("scaled_linear", 10),
                                  betas)
    use = J.space_timesteps(10, "3")
    _assert_same(J.respace(betas, use, rescale_timesteps=True),
                 P.respace(betas, use, rescale_timesteps=True, device="cpu"))


def test_schedule_without_device_needs_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.DiffusionSchedule.create(P.make_beta_schedule("cosine", 10))
