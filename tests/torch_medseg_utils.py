"""Shared helpers of the segmentation and MedSegDiff parity tests
(``test_torch_seg_unet.py``, ``test_torch_medseg_slice.py``): the narrow
MedSegDiffUNet both run, Flax parameters made from a seed and carried into
the port, and the tolerance check of a map against JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dsdiff_tpu.models import seg_unet as J
from dsdiff_torch.models import build_model
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict
from torch_parity_utils import random_flax_params

RTOL = 1e-4

# a narrow MedSegDiffUNet: three levels, attention at rate 4 (8² on 32²)
MEDSEG = dict(xt_channels=1, out_channels=1, model_channels=8,
              num_res_blocks=1, attention_resolutions=(4,),
              channel_mult=(1, 2, 2), num_heads=2, highway_features=8)
HW, B, N_COND = 32, 2, 3
MODES = {"medseg_v1": "highway", "medseg_new": "anchor"}


def close(got, want, rtol=RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rtol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def unit_filters(tree):
    """FFParser's complex weights at unit scale (``random_flax_params``
    gives a leaf that is neither kernel nor scale 0.1 N(0, 1)). At 0.1 the
    fuse gate ``h * ha * hb`` is ~1e-3 of the next conv's bias, and the
    instance norm after it divides that bias's f32 rounding by the gate's
    spread: both packages then carry ~1e-3 of the output in rounding (the
    JAX one the larger against an f64 run), which says nothing of the
    port. At unit scale the two agree to ~2e-6 of the output."""
    if hasattr(tree, "items"):
        return {k: (10.0 * v if k == "complex_weight" else unit_filters(v))
                for k, v in tree.items()}
    return tree


def init_params(jm, seed, *args, **kw):
    tree = jm.init(jax.random.PRNGKey(0), *map(jnp.asarray, args),
                   **kw)["params"]
    return unit_filters(random_flax_params(tree, seed))


def bridged(model, tree):
    model.load_state_dict(flax_to_state_dict(tree, model))
    return model.eval()



def medseg_inputs(seed=9):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, HW, HW, 1 + N_COND)).astype(np.float32)
    return x, np.array([3.0, 700.0], np.float32)


def medseg_pair(name, seed):
    """(JAX module, its random Flax params, the port's model with them)."""
    jm = J.MedSegDiffUNet(mode=MODES[name], **MEDSEG)
    x, t = medseg_inputs()
    tree = init_params(jm, seed, x, t)
    pm = build_model(name, device="cpu", in_channels=1 + N_COND,
                     image_size=HW, **MEDSEG)
    return jm, tree, bridged(pm, tree)
