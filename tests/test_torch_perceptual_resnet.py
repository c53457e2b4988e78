"""The RadImageNet / ResNet50 perceptual distance, the fake-3D distance and
``PerceptualLoss``'s file dispatch (``dsdiff_torch.eval.perceptual``)
against the JAX package's, on the CPU.

One random torchvision-layout ResNet50 file (BatchNorm statistics away from
0 / 1, so that folding them matters) is read by both packages:
``ResNet50Features``' four layers at 64² within 1e-4 of each layer's
largest magnitude, ``RadPerceptual`` within 1e-4 relative, with the
``model.`` / ``backbone.`` / ``module.`` prefixes stripped alike.
``fake_3d_distance`` at ratio 0.5 and seed 1 over [2, 16, 16, 16] volumes
(the proxy pyramid's weights carried over from JAX by the bridge, whose
``_AffineBN`` path is held too) within 1e-4 relative. ``PerceptualLoss``
on each file kind (VGG16, ResNet50 with ``network_type='radimagenet'``, a
pickled pyramid tree, a path that does not exist) against JAX's within
1e-4 relative.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_torch.eval import perceptual as PP
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict
from dsdiff_tpu.eval import perceptual as JP
from torch_eval_weights import (random_resnet50_state_dict,
                                write_safetensors, write_vgg16_file)
from torch_parity_utils import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL = 1e-4


@pytest.fixture(scope="module")
def resnet_file(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resnet")
    sd = random_resnet50_state_dict()
    torch.save(sd, tmp / "resnet50.pth")
    return sd, tmp / "resnet50.pth"


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _pair(shape, seed):
    x = _images(shape, seed)
    return x, np.clip(x + 0.3 * _images(shape, seed + 1), -1, 1)


def test_resnet50_features_match_jax(resnet_file):
    """The four layer outputs at 64², the stem's -inf padded max pool and
    the stride-2 downsample branches included."""
    _, path = resnet_file
    jl = JP.load_resnet50_perceptual(path)
    pl = PP.load_resnet50_perceptual(path, device="cpu")
    x = 0.5 * _images((2, 64, 64, 3), 1) - 0.4  # negative after the stem
    want = jl.net.apply(jl.params, jnp.asarray(x))
    with torch.no_grad():
        got = pl.net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(g.shape) for g in got] == [
        (2, 256, 16, 16), (2, 512, 8, 8), (2, 1024, 4, 4), (2, 2048, 2, 2)]
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=0,
                                   atol=RTOL * float(np.abs(w).max()))
    # the bridge's _AffineBN: JAX's folded params (numpy's f32 rounding of
    # the fold, an ulp from torch's) onto the port's net
    net = PP.ResNet50Features()
    bridged = flax_to_state_dict({"params": jl.params["params"]}, net)
    for k, v in pl.net.state_dict().items():
        torch.testing.assert_close(bridged[k], v, rtol=3e-7, atol=3e-8)


@pytest.mark.parametrize("prefix", ["", "model.", "backbone.", "module."])
def test_rad_perceptual_matches_jax(tmp_path, resnet_file, prefix):
    sd, _ = resnet_file
    path = tmp_path / "w.safetensors"
    if prefix:
        write_safetensors(path, {prefix + k: v for k, v in sd.items()})
    else:
        write_safetensors(path, sd)
    mapped = PP.map_resnet50(sd)
    assert sorted(mapped) == sorted(PP.ResNet50Features().state_dict())
    jl = JP.load_resnet50_perceptual(path)
    pl = PP.load_resnet50_perceptual(path, device="cpu")
    for k, v in mapped.items():
        assert torch.equal(pl.net.state_dict()[k], v), k
    x, y = _pair((2, 64, 64, 1), 3)
    want = np.asarray(jl(jnp.asarray(x), jnp.asarray(y)))
    got = pl(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    assert float(pl(torch.from_numpy(x), torch.from_numpy(x)).abs().max()) \
        < 1e-6


def test_fold_bn_matches_jax(resnet_file):
    sd, _ = resnet_file
    s, b = PP._fold_bn(sd, "layer2.0.downsample.1")
    js, jb = JP._fold_bn({k: v.numpy() for k, v in sd.items()},
                         "layer2.0.downsample.1")
    np.testing.assert_allclose(s.numpy(), js, rtol=3e-7)
    np.testing.assert_allclose(b.numpy(), jb, rtol=3e-7, atol=3e-8)


@pytest.mark.parametrize("axes", [(0, 1, 2), (2,)])
def test_fake_3d_distance_matches_jax(axes):
    """Ratio 0.5, seed 1: the slice indices (arange(n) * S // n + 1) % S and
    the slicing axis moved to position 1."""
    jl = JP.PerceptualLoss(seed=0)
    pl = PP.PerceptualLoss(seed=0, device="cpu")
    pl.net.load_state_dict(flax_to_state_dict(jl.params, pl.net))
    x, y = _pair((2, 16, 16, 16), 5)
    y[:, :, :, ::3] = x[:, :, :, ::3]  # the axes see different slices
    want = JP.fake_3d_distance(jl.distance_fn(), jnp.asarray(x),
                               jnp.asarray(y), axes=axes, ratio=0.5, seed=1)
    got = PP.fake_3d_distance(pl.distance_fn(), torch.from_numpy(x),
                              torch.from_numpy(y), axes=axes, ratio=0.5,
                              seed=1)
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_fake_3d_distance_slices():
    """The distance sees the slices the formula names, in [B, S, a, b]."""
    seen = []

    def record(xs, ys):
        seen.append(xs[..., 0].clone())
        return xs.flatten(1).sum(1)

    x = torch.arange(2 * 4 * 5 * 6, dtype=torch.float32).reshape(2, 4, 5, 6)
    PP.fake_3d_distance(record, x, x, ratio=0.5, seed=1)
    n_keep = [2, 2, 3]
    for ax, (got, n) in enumerate(zip(seen, n_keep)):
        S = x.shape[1 + ax]
        idx = (torch.arange(n) * S // n + 1) % S
        perm = [0, 1 + ax] + [i + 1 for i in range(3) if i != ax]
        want = x.permute(perm)[:, idx].reshape((2 * n,) + got.shape[1:])
        assert torch.equal(got, want), ax
    with pytest.raises(ValueError, match="volumes"):
        PP.fake_3d_distance(record, x[0], x[0])


@pytest.mark.parametrize("kind", ["vgg16", "resnet50", "legacy_tree",
                                  "missing"])
def test_perceptual_loss_file_kinds_match_jax(tmp_path, resnet_file, kind):
    network_type = "lpips"
    if kind == "vgg16":
        path = tmp_path / "vgg.pth"
        write_vgg16_file(path)
    elif kind == "resnet50":
        path, network_type = resnet_file[1], "radimagenet"
    elif kind == "legacy_tree":
        path = tmp_path / "pyramid.pkl"
        tree = jax.tree.map(np.asarray, JP.PerceptualLoss(seed=7).params)
        with open(path, "wb") as f:
            pickle.dump(tree, f)
    else:
        path = tmp_path / "absent.pth"
    jl = JP.PerceptualLoss(seed=0, weights_path=str(path),
                           network_type=network_type)
    pl = PP.PerceptualLoss(seed=0, weights_path=str(path),
                           network_type=network_type, device="cpu")
    real = kind in ("vgg16", "resnet50")
    assert jl.is_real_lpips == pl.is_real_lpips == real
    if kind == "resnet50":
        assert isinstance(pl._lpips, PP.RadPerceptual)
    if kind == "missing":  # the seeded proxy: JAX's weights carried over
        pl.net.load_state_dict(flax_to_state_dict(jl.params, pl.net))
    x, y = _pair((2, 32, 32, 1), 11)
    want = np.asarray(jl(jnp.asarray(x), jnp.asarray(y)))
    got = pl(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL)
