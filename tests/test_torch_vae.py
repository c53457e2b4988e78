"""The latent pipeline's networks against the JAX package's, on the CPU in
f32: the same seeded numpy inputs, every Flax weight random and carried
across through ``utils.flax_bridge``.

- ``AutoencoderKL`` (ch 8, ``ch_mult`` (1, 2): 8 channels, so GroupNorm32
  takes 8 groups; 16² images): the posterior's moments, ``kl``, ``nll``,
  ``mode``, ``decode`` and the whole forward given JAX's posterior noise,
  within 1e-4;
- ``PatchDiscriminator`` within 1e-4, both d-losses within 1e-6;
- the perceptual proxy (the JAX pyramid's weights carried across) and
  LPIPS, both packages reading one torchvision-format VGG16 file with
  random weights and lin heads, within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.eval import perceptual as JP
from dsdiff_tpu.models import discriminator as JD
from dsdiff_tpu.models import vae as JV
from dsdiff_torch.eval import perceptual as PP
from dsdiff_torch.models import discriminator as PD
from dsdiff_torch.models import vae as PV
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict
from torch_parity_utils import one_thread, random_flax_params

pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 1e-4
VAE = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, embed_dim=4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _images(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, shape).astype(np.float32)


@pytest.fixture(scope="module")
def vae_pair():
    jm = JV.AutoencoderKL(**VAE)
    x = jnp.zeros((1, 16, 16, 1))
    rng = jax.random.PRNGKey(0)
    tree = random_flax_params(jm.init(rng, x, rng)["params"], 21)
    pm = PV.AutoencoderKL(**VAE)
    pm.load_state_dict(flax_to_state_dict(tree, pm))
    return jm, {"params": tree}, pm


def test_vae_weights_map_one_to_one(vae_pair):
    """Every leaf of the Flax tree lands on a parameter of the port's
    module (the attention's separate q, k, v, proj_out Denses and the
    quant convs included), and the counts agree."""
    _, params, pm = vae_pair
    n_flax = sum(np.size(p) for p in jax.tree.leaves(params))
    assert n_flax == sum(p.numel() for p in pm.parameters())
    names = dict(pm.named_parameters())
    for key in ("encoder.mid_attn.q.weight", "decoder.mid_attn.proj_out.bias",
                "quant_conv.weight", "post_quant_conv.weight",
                "encoder.down_0_ds.weight", "decoder.up_1_us.weight"):
        assert key in names, key


def test_encode_moments_kl_nll_mode_and_decode(vae_pair):
    jm, params, pm = vae_pair
    x = _images((2, 16, 16, 1), 1)
    post = jm.apply(params, jnp.asarray(x), method="encode")
    got = pm.encode(torch.from_numpy(x))
    np.testing.assert_allclose(got.mean.detach().numpy(),
                               np.asarray(post.mean), atol=ATOL)
    np.testing.assert_allclose(got.logvar.detach().numpy(),
                               np.asarray(post.logvar), atol=ATOL)
    assert got.mean.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(got.kl().detach().numpy(),
                               np.asarray(post.kl()), rtol=1e-4)
    z = _images((2, 8, 8, 4), 2)
    np.testing.assert_allclose(got.nll(torch.from_numpy(z)).detach().numpy(),
                               np.asarray(post.nll(jnp.asarray(z))),
                               rtol=1e-4)
    assert got.mode() is got.mean
    dec = jm.apply(params, jnp.asarray(z), method="decode")
    out = pm.decode(torch.from_numpy(z))
    assert out.dtype == torch.float32 and out.shape == (2, 16, 16, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(dec),
                               atol=ATOL)


def test_logvar_is_clipped_as_jax_clips_it():
    moments = np.concatenate([np.zeros((1, 2, 2, 2), np.float32),
                              np.array([-50.0, 30.0], np.float32)
                              * np.ones((1, 2, 2, 2), np.float32)], -1)
    want = JV.DiagonalGaussian.from_moments(jnp.asarray(moments))
    got = PV.DiagonalGaussian.from_moments(torch.from_numpy(moments))
    np.testing.assert_array_equal(got.logvar.numpy(), np.asarray(want.logvar))
    assert got.logvar.min() == -30.0 and got.logvar.max() == 20.0


def test_forward_given_jax_posterior_noise(vae_pair):
    jm, params, pm = vae_pair
    x = _images((2, 16, 16, 1), 3)
    rng = jax.random.PRNGKey(7)
    rec, post = jm.apply(params, jnp.asarray(x), rng)
    noise = jax.random.normal(rng, post.mean.shape, post.mean.dtype)
    got, _ = pm(torch.from_numpy(x), _t(noise))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(rec),
                               atol=ATOL)
    mode_rec, _ = pm(torch.from_numpy(x), sample_posterior=False)
    want = jm.apply(params, post.mean, method="decode")
    np.testing.assert_allclose(mode_rec.detach().numpy(), np.asarray(want),
                               atol=ATOL)


def test_vae_attention_is_one_head_over_all_channels(vae_pair, monkeypatch):
    """The bottleneck attention calls ``scaled_attention`` once per block
    with [B, N, 1, C]: one head, C = ch * ch_mult[-1]."""
    _, _, pm = vae_pair
    shapes = []
    real = PV.scaled_attention

    def spy(q, k, v):
        shapes.append(tuple(q.shape))
        return real(q, k, v)

    monkeypatch.setattr(PV, "scaled_attention", spy)
    pm(torch.from_numpy(_images((2, 16, 16, 1), 4)),
       torch.zeros(2, 8, 8, 4))
    assert shapes == [(2, 64, 1, 16)] * 2


def test_discriminator_matches_jax():
    jd = JD.PatchDiscriminator(base_channels=8, n_layers=3)
    x = _images((2, 32, 32, 1), 5)
    tree = random_flax_params(
        jd.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], 22)
    want = jd.apply({"params": tree}, jnp.asarray(x))
    pd = PD.PatchDiscriminator(base_channels=8, n_layers=3)
    pd.load_state_dict(flax_to_state_dict(tree, pd))
    got = pd(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 2, 2, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)


@pytest.mark.parametrize("name", ["hinge_d_loss", "vanilla_d_loss"])
def test_d_losses_match_jax(name):
    rng = np.random.default_rng(6)
    real, fake = (2.0 * rng.standard_normal((2, 6, 6, 1)).astype(np.float32)
                  for _ in range(2))
    want = getattr(JD, name)(jnp.asarray(real), jnp.asarray(fake))
    got = getattr(PD, name)(torch.from_numpy(real), torch.from_numpy(fake))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)


def test_perceptual_proxy_matches_jax_with_its_weights():
    jl = JP.PerceptualLoss(seed=0)
    pl = PP.PerceptualLoss(seed=0, device="cpu")
    assert not pl.is_real_lpips
    pl.net.load_state_dict(flax_to_state_dict(jl.params, pl.net))
    x = _images((2, 32, 32, 1), 8)
    y = np.clip(x + 0.3 * _images((2, 32, 32, 1), 9), -1, 1)
    want = jl(jnp.asarray(x), jnp.asarray(y))
    got = pl.distance_fn()(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # differentiable in its inputs, the network frozen
    xt = torch.from_numpy(x).requires_grad_(True)
    pl(xt, torch.from_numpy(y)).sum().backward()
    assert xt.grad.abs().sum() > 0
    assert all(not p.requires_grad for p in pl.net.parameters())


def test_perceptual_proxy_is_seeded():
    a = PP.PerceptualLoss(seed=3, device="cpu")
    b = PP.PerceptualLoss(seed=3, device="cpu")
    c = PP.PerceptualLoss(seed=4, device="cpu")
    for (na, pa), (_, pb), (_, pc) in zip(a.net.named_parameters(),
                                          b.net.named_parameters(),
                                          c.net.named_parameters()):
        assert torch.equal(pa, pb), na
        if na.endswith("weight"):
            assert not torch.equal(pa, pc), na


@pytest.mark.parametrize("with_lins", [True, False])
def test_lpips_with_random_vgg16_weights_matches_jax(tmp_path, with_lins):
    """Both packages read one local torchvision-format VGG16 file (random
    weights, and the lpips lin heads or none: the uniform mean)."""
    rng = np.random.default_rng(10)
    sd = {}
    cin = 3
    for width, idxs in JP._VGG16_LAYOUT:
        for i in idxs:
            sd[f"features.{i}.weight"] = torch.from_numpy(
                (rng.standard_normal((width, cin, 3, 3))
                 / np.sqrt(9 * cin)).astype(np.float32))
            sd[f"features.{i}.bias"] = torch.from_numpy(
                (0.1 * rng.standard_normal(width)).astype(np.float32))
            cin = width
    if with_lins:
        for k, (w, _) in enumerate(JP._VGG16_LAYOUT):
            sd[f"lin{k}.model.1.weight"] = torch.from_numpy(
                rng.uniform(0, 1, (1, w, 1, 1)).astype(np.float32))
    path = tmp_path / "vgg.pth"
    torch.save(sd, path)

    jl = JP.PerceptualLoss(weights_path=str(path))
    pl = PP.PerceptualLoss(weights_path=str(path), device="cpu")
    assert jl.is_real_lpips and pl.is_real_lpips
    assert (pl._lpips.lins[0] is not None) == with_lins
    x = _images((2, 32, 32, 1), 11)
    y = np.clip(x + 0.3 * _images((2, 32, 32, 1), 12), -1, 1)
    want = jl(jnp.asarray(x), jnp.asarray(y))
    got = pl(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=1e-4)
    np.testing.assert_allclose(
        pl(torch.from_numpy(x), torch.from_numpy(x)).detach().numpy(), 0.0,
        atol=1e-6)


def test_lpips_refuses_incomplete_weights_and_other_backbones(tmp_path):
    """An incomplete VGG16 file is refused by both backbones' loaders, and
    by ``PerceptualLoss`` in both packages: after the backbone's load fails
    it reads the file as a pickled pyramid tree (the JAX package's order),
    which fails too, its error carrying the loader's."""
    path = tmp_path / "partial.pth"
    torch.save({"features.0.weight": torch.zeros(64, 3, 3, 3)}, path)
    with pytest.raises(ValueError, match="incomplete"):
        PP.load_vgg16_lpips(str(path), device="cpu")
    with pytest.raises(ValueError, match="incomplete"):
        PP.load_resnet50_perceptual(str(path), device="cpu")
    for network_type in ("lpips", "radimagenet"):
        with pytest.raises(Exception) as err:
            PP.PerceptualLoss(weights_path=str(path),
                              network_type=network_type, device="cpu")
        first = err.value.__context__
        assert isinstance(first, ValueError) and "incomplete" in str(first)
        with pytest.raises(Exception):
            JP.PerceptualLoss(weights_path=str(path),
                              network_type=network_type)