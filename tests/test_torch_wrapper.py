"""``models.wrapper.conditioned_call`` against the JAX package's, every
conditioning mode: the same inputs reach the denoiser in the same places
(exact: concatenation only)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.models.wrapper import CONDITIONING_MODES as JAX_MODES
from dsdiff_tpu.models.wrapper import conditioned_call as jax_call
from dsdiff_torch.models import conditioned_call
from dsdiff_torch.models.wrapper import CONDITIONING_MODES


def _recorder(calls):
    def fake(x, t, context=None, y=None):
        calls.append({"x": x, "t": t, "context": context, "y": y})
        return x
    return fake


@pytest.mark.parametrize("mode", CONDITIONING_MODES)
def test_conditioned_call_matches_jax(mode):
    assert tuple(JAX_MODES) == CONDITIONING_MODES
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 4, 1)).astype(np.float32)
    t = np.array([3.0, 9.0], np.float32)
    cond = {"c_concat": [rng.standard_normal((2, 4, 4, 2)).astype(np.float32),
                         rng.standard_normal((2, 4, 4, 1)).astype(np.float32)],
            "c_crossattn": [rng.standard_normal((2, 3, 8)).astype(np.float32)] * 2,
            "c_adm": rng.standard_normal((2, 5)).astype(np.float32)}
    got, want = [], []
    conditioned_call(_recorder(got), mode, torch.from_numpy(x),
                     torch.from_numpy(t),
                     {k: [torch.from_numpy(a) for a in v] if isinstance(v, list)
                      else torch.from_numpy(v) for k, v in cond.items()})
    jax_call(_recorder(want), mode, jnp.asarray(x), jnp.asarray(t),
             {k: [jnp.asarray(a) for a in v] if isinstance(v, list)
              else jnp.asarray(v) for k, v in cond.items()})
    for k in ("x", "t", "context", "y"):
        g, w = got[0][k], want[0][k]
        assert (g is None) == (w is None), k
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)
    with pytest.raises(ValueError, match="unknown conditioning mode"):
        conditioned_call(_recorder([]), "bogus", torch.from_numpy(x),
                         torch.from_numpy(t))
