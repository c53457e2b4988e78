"""InceptionV3 (``dsdiff_torch.models.inception``) and the FID / VIF
functions (``dsdiff_torch.eval.fid``) against the JAX package's, on the CPU.

One random torchvision-layout inception file (with ``fc`` and ``AuxLogits``
heads the trunk ignores) is read by both packages: the pool3 features of
both variants within 1e-4 of their largest magnitude at 75² without the
resize, and for ``pt_fid`` on one image resized up (256² -> 299², plain
bilinear) and one resized down (320² -> 299², antialiased, as
``jax.image.resize`` shrinks). ``FeatureStats``, ``frechet_distance`` (and
its branch for a non-finite trace) and ``vifp`` are copies of the JAX code
and agree to 1e-10. ``fid()`` through the seed-0 proxy pyramid (its
weights carried over from JAX by the bridge: threefry and Philox never draw
the same numbers) and through the inception extractor, from a .pth and a
.safetensors file, within 1e-4 relative. The bridge carries a Flax
inception's ``params`` + ``batch_stats`` back to the torch state dict it
came from, exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_torch.eval import fid as PF
from dsdiff_torch.eval import perceptual as PP
from dsdiff_torch.models import inception as PI
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict
from dsdiff_tpu.eval import fid as JF
from dsdiff_tpu.eval import perceptual as JP
from dsdiff_tpu.models import inception as JI
from torch_eval_weights import (random_inception_state_dict,
                                write_safetensors)
from torch_parity_utils import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

FEAT_RTOL = 1e-4  # of the features' largest magnitude
FID_RTOL = 1e-4
EXACT = 1e-10


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("inception")
    sd = random_inception_state_dict()
    torch.save(sd, tmp / "inception.pth")
    write_safetensors(tmp / "inception.safetensors", sd)
    return {"sd": sd, "pth": tmp / "inception.pth",
            "safetensors": tmp / "inception.safetensors"}


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _close(got, want, rtol=FEAT_RTOL):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def jax_extractor(weights):
    """JAX's pt_fid extractor at 75² without the resize, loaded and
    compiled once for the module (batches of 1 and 3)."""
    return JF.make_inception_extractor(weights["pth"], batch_resize=False)


@pytest.mark.parametrize("variant", ["pt_fid", "torchvision"])
def test_inception_features_match_jax(weights, jax_extractor, variant):
    x = _images((3, 75, 75, 3), 1)
    if variant == "pt_fid":
        want = jax_extractor(x)
    else:
        jnet, jvars = JI.load_inception(weights["pth"], resize_input=False,
                                        variant=variant)
        want = np.asarray(jax.jit(jnet.apply)(jvars, jnp.asarray(x)))
    net = PI.load_inception(weights["pth"], resize_input=False,
                            variant=variant, device="cpu")
    assert not any(p.requires_grad for p in net.parameters())
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (3, 2048)
    _close(got, want)


def _random_variables(tree, rng):
    """A Flax variables tree filled at random: kernels He-scaled, BatchNorm
    scales near 1, variances in [0.5, 1.5], the rest small normals."""
    def fill(node, name):
        if hasattr(node, "items"):
            return {k: fill(v, k) for k, v in node.items()}
        shape = np.shape(node)
        if name == "kernel":
            val = rng.standard_normal(shape) * np.sqrt(2 / np.prod(shape[:-1]))
        elif name == "var":
            val = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            val = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            val = 0.1 * rng.standard_normal(shape)
        return val.astype(np.float32)

    return fill(tree, "")


@pytest.mark.parametrize("pool_mode", ["max", "avg"])
def test_inception_e_pools_match_jax(pool_mode):
    """Mixed_7c's pool branch, max (pt_fid) or average without the padding
    in the count (torchvision), at 5² where the edges count: at 75² input
    the block sees 1² and the variants agree."""
    x = _images((2, 5, 5, 8), 2)
    jm = JI.InceptionE(pool_mode=pool_mode)
    shapes = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = _random_variables(jax.tree.map(np.asarray, shapes),
                                  np.random.default_rng(3))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    net = PI.InceptionE(8, pool_mode).eval()
    net.load_state_dict(flax_to_state_dict(variables, net))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1).numpy(), want)
    other = PI.InceptionE(8, "avg" if pool_mode == "max" else "max").eval()
    other.load_state_dict(net.state_dict())
    with torch.no_grad():
        assert not torch.allclose(other(torch.from_numpy(x).permute(
            0, 3, 1, 2)), got, atol=1e-3)


@pytest.mark.parametrize("side", [256, 320])
def test_inception_resize_matches_jax(weights, side):
    """Grown (256²) and shrunk (320²) to 299² inside the network."""
    x = _images((1, side, side, 3), side)
    want = JF.make_inception_extractor(weights["pth"])(x)
    got = PF.make_inception_extractor(weights["pth"], device="cpu")(x)
    _close(got, want)


def test_inception_parity_traps():
    """BatchNorm eps 1e-3, count_include_pad=False average pools in both
    variants, a SAME max pool in pt_fid's Mixed_7c, (0, 3) padding."""
    net = PI.InceptionV3(variant="torchvision")
    assert all(m.eps == 1e-3 for m in net.modules()
               if isinstance(m, torch.nn.BatchNorm2d))
    assert net.Mixed_6b.branch7x7_2.conv.padding == (0, 3)
    assert net.Mixed_6b.branch7x7_3.conv.padding == (3, 0)
    x = torch.ones(1, 2, 4, 4)
    torch.testing.assert_close(PI._avg_pool3_nocount(x), x)  # edges too
    assert PI.InceptionV3().Mixed_7c.pool_mode == "max"
    assert net.Mixed_7c.pool_mode == net.Mixed_7b.pool_mode == "avg"
    with pytest.raises(ValueError, match="variant"):
        PI.InceptionV3(variant="keras")


def test_inception_raises_on_missing_weights(tmp_path, weights):
    sd = dict(weights["sd"])
    del sd["Mixed_6c.branch7x7dbl_4.bn.running_var"]
    torch.save(sd, tmp_path / "partial.pth")
    with pytest.raises(ValueError, match="incomplete"):
        PI.load_inception(tmp_path / "partial.pth", device="cpu")
    with pytest.raises(ValueError, match="incomplete"):
        JI.load_inception(tmp_path / "partial.pth")


def _nest(flat: dict) -> dict:
    tree = {}
    for path, v in flat.items():
        node = tree
        *mods, leaf = path.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


def test_bridge_carries_flax_batchnorm_round_trip(weights):
    """torch state dict -> JAX ``map_inception`` (params/scale, bias;
    batch_stats/mean, var; HWIO kernels incl. (1, 7) and (7, 1)) -> the
    port's bridge -> the same state dict."""
    sd = weights["sd"]
    variables = _nest(JI.map_inception({k: v.numpy() for k, v in sd.items()}))
    assert set(variables) == {"params", "batch_stats"}
    assert variables["params"]["Mixed_6b"]["branch7x7_2"]["conv"][
        "kernel"].shape[:2] == (1, 7)
    net = PI.InceptionV3()
    back = flax_to_state_dict(variables, net)
    for k, v in net.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(back[k]) == 0
        else:
            assert torch.equal(back[k], sd[k]), k
    net.load_state_dict(back)


def test_feature_stats_and_frechet_match_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((40, 6))
    b = 0.5 + 1.3 * rng.standard_normal((35, 6))
    sa, sb = PF.FeatureStats(6), JF.FeatureStats(6)
    for i in range(0, 40, 16):
        sa.update(a[i:i + 16])
        sb.update(a[i:i + 16])
    np.testing.assert_allclose(sa.mean, sb.mean, rtol=0, atol=EXACT)
    np.testing.assert_allclose(sa.cov, sb.cov, rtol=0, atol=EXACT)
    np.testing.assert_allclose(sa.cov, np.cov(a, rowvar=False), atol=1e-10)
    args = (a.mean(0), np.cov(a, rowvar=False), b.mean(0),
            np.cov(b, rowvar=False))
    got, want = PF.frechet_distance(*args), JF.frechet_distance(*args)
    assert abs(got - want) <= EXACT * max(1.0, abs(want))
    assert abs(PF.frechet_distance(args[0], args[1], args[0], args[1])) < 1e-8


def test_frechet_non_finite_branch_matches_jax(monkeypatch):
    """A non-finite trace of sqrt(C1 C2) is retried with eps on the
    diagonals, in both packages: the first eigenvalue solve is made to
    return an infinity."""
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((2, 20, 5))
    args = (a.mean(0), np.cov(a, rowvar=False), b.mean(0),
            np.cov(b, rowvar=False))
    real = np.linalg.eigvalsh
    results = []
    for mod in (PF, JF):
        calls = []

        def first_inf(m, calls=calls):
            calls.append(m)
            w = real(m)
            return w + np.inf if len(calls) == 1 else w

        monkeypatch.setattr(np.linalg, "eigvalsh", first_inf)
        results.append(mod.frechet_distance(*args, eps=1e-3))
        monkeypatch.setattr(np.linalg, "eigvalsh", real)
        assert len(calls) == 2  # the retry ran
    plain = PF.frechet_distance(*args)
    assert np.isfinite(results[0]) and results[0] != plain
    assert abs(results[0] - results[1]) <= EXACT * abs(results[1])


@pytest.mark.parametrize("shape", [(48, 40), (40, 36, 3)])
def test_vifp_matches_jax(shape):
    rng = np.random.default_rng(5)
    ref = rng.uniform(0, 1, shape)
    dist = ref + 0.1 * rng.standard_normal(shape)
    got, want = PF.vifp(ref, dist), JF.vifp(ref, dist)
    assert abs(got - want) <= EXACT
    assert abs(PF.vifp(ref, ref) - 1.0) < 1e-6


def test_fid_with_bridged_proxy_matches_jax():
    """``fid()``'s default extractor: the seed-0 pyramid, JAX's weights
    carried across; and the port's own default runs on device='cpu'."""
    real = _images((6, 32, 32, 1), 6)
    fake = np.clip(real + 0.2 * _images((6, 32, 32, 1), 7), -1, 1)
    want = JF.fid(real, fake, batch=4)
    pl = PP.PerceptualLoss(seed=0, device="cpu")
    pl.net.load_state_dict(flax_to_state_dict(
        JP.PerceptualLoss(seed=0).params, pl.net))
    got = PF.fid(real, fake, extractor=PF.proxy_extractor(pl), batch=4)
    np.testing.assert_allclose(got, want, rtol=FID_RTOL)
    own = PF.fid(real, fake, batch=4, device="cpu")
    again = PF.fid(real, fake, batch=4, device="cpu",
                   extractor=PF.proxy_extractor(
                       PP.PerceptualLoss(seed=0, device="cpu")))
    assert own == again and np.isfinite(own) and own > 0


@pytest.mark.parametrize("kind", ["pth", "safetensors"])
def test_fid_with_inception_extractor_matches_jax(weights, jax_extractor,
                                                  kind):
    real = _images((3, 75, 75, 1), 8)
    fake = np.clip(real + 0.3 * _images((3, 75, 75, 1), 9), -1, 1)
    jext = jax_extractor
    pext = PF.make_inception_extractor(weights[kind], batch_resize=False,
                                       device="cpu")
    _close(pext(real), jext(real))
    want = JF.fid(real, fake, extractor=jext, batch=3)
    got = PF.fid(real, fake, extractor=pext, batch=3)
    np.testing.assert_allclose(got, want, rtol=FID_RTOL)


def test_extractor_reads_pth_and_safetensors_alike(weights):
    x = _images((2, 75, 75, 3), 10)
    a = PF.make_inception_extractor(weights["pth"], batch_resize=False,
                                    device="cpu")(x)
    b = PF.make_inception_extractor(weights["safetensors"],
                                    batch_resize=False, device="cpu")(x)
    assert np.array_equal(a, b)
