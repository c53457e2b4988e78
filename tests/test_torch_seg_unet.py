"""The segmentation networks and the MedSegDiff denoisers of the port
(``dsdiff_torch/models/seg_unet.py``) against the JAX package's, f32 on the
CPU: the same seeded numpy inputs and the same Flax weights, carried across
by ``utils.flax_bridge`` (``random_flax_params``' weights, FFParser's
complex weights at unit scale: ``torch_medseg_utils.unit_filters`` says
why). The train step and a request of each MedSegDiff mode are in
``test_torch_medseg_slice.py``.

Tolerances, of max(1, max |out|):

- FFParser: 2e-4 (XLA's and PyTorch's FFTs differ by summation order).
- ``_ConvBlock``, ``SegUNet``, ``HighwayUNet``, ``MedSegDiffUNet`` (out
  and cal): 1e-4.
- ``sliding_window_inference``: with the same per-tile probabilities (the
  JAX model's, given to the port's tiling) the labels are JAX's exactly;
  with the port's model its probabilities within 1e-5 of those, and its
  labels JAX's wherever the two top probabilities are more than 1e-5
  apart.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.models import seg_unet as J
from dsdiff_torch.models import attention as attention_module
from dsdiff_torch.models import build_model
from dsdiff_torch.models import seg_unet as P
from dsdiff_torch.ops import flash_attention as PF
from dsdiff_torch.utils import flax_bridge
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict
from torch_medseg_utils import (B, HW, MEDSEG, MODES, bridged, close,
                                init_params, medseg_inputs, medseg_pair)
from torch_parity_utils import nchw_to_nhwc, nhwc_to_nchw, one_thread

pytestmark = pytest.mark.usefixtures("one_thread")

FFT_RTOL = 2e-4
PROB_ATOL = 1e-5


# ------------------------------------------------------------ the blocks
@pytest.mark.parametrize("W", [12, 13])
def test_ffparser_matches_jax_on_both_sides_of_irffts_crop(W):
    """Even and odd W: irfft2 must give back W columns from W//2+1."""
    x = np.random.default_rng(W).standard_normal((2, 10, W, 5)).astype(
        np.float32)
    jm = J.FFParser(10, W)
    tree = init_params(jm, 1, x)
    pm = bridged(P.FFParser(5, 10, W), tree)
    got = nchw_to_nhwc(pm(nhwc_to_nchw(x)))
    close(got, jm.apply({"params": tree}, jnp.asarray(x)), FFT_RTOL)
    # bf16 in, f32 inside, bf16 out
    out16 = pm(nhwc_to_nchw(x).bfloat16())
    assert out16.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="FFParser built for 10x"):
        pm(torch.zeros(1, 5, 10, W + 2))


def test_conv_block_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 9, 9, 3)).astype(
        np.float32)
    jm = J._ConvBlock(6, stride=2)
    tree = init_params(jm, 3, x)
    pm = bridged(P._ConvBlock(3, 6, stride=2), tree)
    close(nchw_to_nhwc(pm(nhwc_to_nchw(x))), jm.apply({"params": tree}, x))


@pytest.mark.parametrize("deep_supervision", [False, True])
def test_seg_unet_matches_jax(deep_supervision):
    """Features 8, 16, 16, 16: ``up_2_tr`` is 16 -> 16, whose kernel only
    the bridge's transposed-conv rule (flip, [I, O, kh, kw]) maps right."""
    kw = dict(in_channels=2, num_classes=3, base_features=8, num_pool=3,
              max_features=16, deep_supervision=deep_supervision)
    x = np.random.default_rng(4).standard_normal((2, 32, 32, 2)).astype(
        np.float32)
    jm = J.SegUNet(**kw)
    tree = init_params(jm, 5, x)
    pm = bridged(P.SegUNet(**kw), tree)
    assert pm.up_2_tr.in_channels == pm.up_2_tr.out_channels == 16
    got = pm(torch.from_numpy(x))
    want = jm.apply({"params": tree}, jnp.asarray(x))
    if not deep_supervision:
        got, want = [got], [want]
    assert len(got) == len(want) == (3 if deep_supervision else 1)
    for g, w in zip(got, want):
        close(g, w, what="seg")


def test_highway_unet_matches_jax_in_fuse_and_anchor_mode():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 32, 32, 2)).astype(np.float32)
    hs = [rng.standard_normal((2, 16, 16, 5)).astype(np.float32),
          rng.standard_normal((2, 8, 8, 7)).astype(np.float32)]
    kw = dict(in_channels=2, base_features=8, num_pool=2, emb_dim=16)
    jm = J.HighwayUNet(**kw)
    tree = init_params(jm, 7, x, hs=[jnp.asarray(h) for h in hs])
    pm = bridged(P.HighwayUNet(fuse_channels=[5, 7],
                                fuse_sizes=[(16, 16), (8, 8)], **kw), tree)
    emb, cal = pm(nhwc_to_nchw(x), [nhwc_to_nchw(h) for h in hs])
    jemb, jcal = jm.apply({"params": tree}, jnp.asarray(x),
                          [jnp.asarray(h) for h in hs])
    close(nchw_to_nhwc(emb), jemb, what="emb")
    close(nchw_to_nhwc(cal), jcal, what="cal")

    jm = J.HighwayUNet(anchor_out=True, **kw)
    tree = init_params(jm, 8, x)
    pm = bridged(P.HighwayUNet(anchor_out=True, **kw), tree)
    anchors, cal = pm(nhwc_to_nchw(x))
    janchors, jcal = jm.apply({"params": tree}, jnp.asarray(x))
    assert len(anchors) == len(janchors) == 2
    for a, ja in zip(anchors, janchors):
        assert a.shape[-2:] == (32, 32)
        close(nchw_to_nhwc(a), ja, what="anchor")
    close(nchw_to_nhwc(cal), jcal, what="cal")


# ------------------------------------------------------------ MedSegDiff
@pytest.mark.parametrize("name", sorted(MODES))
def test_medseg_unet_matches_jax(name):
    jm, tree, pm = medseg_pair(name, 10)
    x, t = medseg_inputs()
    out, aux = pm(torch.from_numpy(x), torch.from_numpy(t))
    jout, jaux = jm.apply({"params": tree}, jnp.asarray(x), jnp.asarray(t))
    assert out.shape == (B, HW, HW, 1) and aux["cal"].shape == (B, HW, HW, 1)
    close(out, jout, what="out")
    close(aux["cal"], jaux["cal"], what="cal")


def test_medseg_attention_goes_through_scaled_attention(monkeypatch):
    """The attention blocks call the kernel's dispatch, which on the CPU
    runs the plain version and counts no launch: four calls a forward here
    (at rate 4: the encoder's block, the middle's and the decoder's two)."""
    _, _, pm = medseg_pair("medseg_v1", 10)
    calls = []

    def counting(q, k, v):
        calls.append(q.shape)
        return PF.reference_attention(q, k, v)

    monkeypatch.setattr(attention_module, "scaled_attention", counting)
    x, t = medseg_inputs()
    before = PF.LAUNCHES
    with torch.no_grad():
        pm(torch.from_numpy(x), torch.from_numpy(t))
    assert PF.LAUNCHES == before
    assert calls == [(B, 64, 2, 8)] * 4


@pytest.mark.parametrize("name", sorted(MODES))
def test_gradient_reaches_what_the_loss_reaches(name):
    """Anchor mode: the anchors enter detached, so the whole highway gets no
    gradient from the denoiser's output while the trunk does (the JAX
    package's slow test, at a size that runs in a second). Highway mode:
    the highway's decoder and ``seg_out`` feed ``cal`` only, so an
    output-only loss leaves them without gradient and its encoder gets
    one."""
    _, _, pm = medseg_pair(name, 11)
    pm.train()
    x, t = medseg_inputs()
    out, _ = pm(torch.from_numpy(x), torch.from_numpy(t))
    (out ** 2).mean().backward()
    grads = {n: p.grad for n, p in pm.named_parameters()}
    unreached = [n for n, g in grads.items() if g is None or not g.any()]
    if name == "medseg_new":
        assert sorted(unreached) == sorted(n for n in grads
                                           if n.startswith("hwm."))
        assert grads["anchor_proj.weight"].abs().max() > 0
    else:
        assert sorted(unreached) == sorted(
            n for n in grads if n.startswith(("hwm.up_", "hwm.seg_out.")))
        assert grads["hwm.hw_0_ff.complex_weight"].abs().max() > 0
    for prefix in ("time_embed.", "encoder.", "middle.", "decoder.", "out."):
        assert any(g is not None and g.any() for n, g in grads.items()
                   if n.startswith(prefix)), prefix


def test_registry_builds_both_modes_and_trainer_refuses_like_jax(tmp_path):
    """``in_channels`` sets the condition width (the JAX factory drops it,
    Flax infers it); both Trainers pass ``remat`` to the MedSegDiff factory,
    which takes none, and fail alike."""
    from dsdiff_tpu.train.config import Config as JConfig
    from dsdiff_tpu.train.trainer import Trainer as JTrainer
    from dsdiff_torch.train.trainer import Trainer
    from torch_parity_utils import tiny_cfg

    m = build_model("medseg_v1", device="cpu", in_channels=6, image_size=16,
                    **dict(MEDSEG, attention_resolutions=()))
    assert m.mode == "highway" and m.encoder.in_conv.in_channels == 6
    assert m.hwm.down_0_a.conv.in_channels == 5
    m2 = build_model("medseg_new", device="cpu", out_channels=1,
                     model_channels=8, num_res_blocks=1,
                     attention_resolutions=(), channel_mult=(1, 2),
                     highway_features=8)
    assert m2.mode == "anchor"
    cfg = dict(tiny_cfg(), unet_config={"params": dict(
        model_channels=8, num_res_blocks=1, attention_resolutions=[2],
        channel_mult=[1, 2], num_heads=2)})
    for net_mode in MODES:
        with pytest.raises(TypeError, match="'remat'"):
            Trainer(dict(cfg, net_mode=net_mode), device="cpu")
        with pytest.raises(TypeError, match="'remat'"):
            JTrainer(JConfig.wrap(dict(cfg, net_mode=net_mode)), tmp_path)


# ------------------------------------------------------------ bridge
def test_bridge_maps_transposed_conv_kernels_by_module_type():
    """A 320 -> 320 transposed conv (SegUNet's ``up_4_tr`` at its defaults):
    the HWIO kernel has the same shape in the plain conv's OIHW layout, so
    only the module's type can pick the layout; the bridge flips it into
    [I, O, kh, kw] and the round trip gives the Flax kernel back."""
    k = np.random.default_rng(12).standard_normal((2, 2, 320, 320)).astype(
        np.float32)
    tr = P.ConvTranspose(320, 320, 2, stride=2)
    got = flax_bridge._leaf_to_torch(k, "kernel", 4, tr)
    np.testing.assert_array_equal(got, k[::-1, ::-1].transpose(2, 3, 0, 1))
    assert not np.array_equal(got, k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(got[:, :, ::-1, ::-1].transpose(2, 3, 0, 1), k)
    plain = flax_bridge._leaf_to_torch(k, "kernel", 4, torch.nn.Conv2d(
        320, 320, 2))
    np.testing.assert_array_equal(plain, k.transpose(3, 2, 0, 1))
    # and the model's forward with it: one up-conv, JAX against the port
    x = np.random.default_rng(13).standard_normal((1, 3, 3, 320)).astype(
        np.float32)
    import flax.linen as nn

    jtr = nn.ConvTranspose(320, (2, 2), strides=(2, 2))
    tree = {"kernel": k, "bias": np.zeros(320, np.float32)}
    want = jtr.apply({"params": tree}, jnp.asarray(x))
    tr.load_state_dict({"weight": torch.from_numpy(got.copy()),
                        "bias": torch.zeros(320)})
    close(nchw_to_nhwc(tr(nhwc_to_nchw(x))), want)


def test_bridge_round_trips_complex_weight():
    jm = J.FFParser(8, 9)
    x = np.zeros((1, 8, 9, 3), np.float32)
    tree = init_params(jm, 14, x)
    pm = P.FFParser(3, 8, 9)
    sd = flax_to_state_dict(tree, pm)
    assert sd["complex_weight"].shape == (3, 8, 5, 2)
    np.testing.assert_array_equal(
        sd["complex_weight"].numpy().transpose(1, 2, 0, 3),
        tree["complex_weight"])


# ------------------------------------------------------------ sliding window
def test_sliding_window_inference_matches_jax():
    """A 40 x 44 x 5 volume, 32² tiles at overlap 0.5 (2 x 2 tiles, each
    overlapping its neighbour), z-chunks of 2: the last chunk is padded."""
    kw = dict(in_channels=1, num_classes=3, base_features=4, num_pool=2,
              max_features=8)
    vol = np.random.default_rng(15).standard_normal((40, 44, 5, 1)).astype(
        np.float32)
    jm = J.SegUNet(**kw)
    tree = init_params(jm, 16, vol[:32, :32, :1].transpose(2, 0, 1, 3))
    pm = bridged(P.SegUNet(**kw), tree)
    args = dict(tile=32, overlap=0.5, num_classes=3, batch=2)
    japply = lambda p, x: jm.apply(p, x)  # noqa: E731
    want = J.sliding_window_inference(japply, {"params": tree}, vol, **args)
    assert want.shape == (40, 44, 5)

    def jax_tiles(x):  # the JAX model's logits, for the port's tiling
        out = jm.apply({"params": tree}, jnp.asarray(nchw_to_nhwc(x)))
        return nhwc_to_nchw(np.asarray(out))

    def port_tiles(x):
        return pm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)

    np.testing.assert_array_equal(P.sliding_window_inference(
        jax_tiles, vol, device="cpu", **args), want)
    want_p = P.sliding_window_probabilities(jax_tiles, vol, device="cpu",
                                            **args)
    got_p = P.sliding_window_probabilities(port_tiles, vol, device="cpu",
                                           **args)
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=PROB_ATOL)
    top2 = np.sort(want_p, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > PROB_ATOL
    got = P.sliding_window_inference(port_tiles, vol, device="cpu", **args)
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got[clear], want[clear])


def test_sliding_window_clamps_tiles_to_a_smaller_volume():
    """A volume smaller than the tile: one tile of the volume's size and the
    Gaussian cut to it, as the JAX function does. Where the clamped tile is
    not square the JAX function's square Gaussian does not broadcast; the
    port refuses that volume up front."""
    kw = dict(in_channels=1, num_classes=2, base_features=4, num_pool=2,
              max_features=8)
    vol = np.random.default_rng(17).standard_normal((24, 24, 3, 1)).astype(
        np.float32)
    jm = J.SegUNet(**kw)
    tree = init_params(jm, 18, vol[:, :, :1].transpose(2, 0, 1, 3))
    japply = lambda p, x: jm.apply(p, x)  # noqa: E731
    want = J.sliding_window_inference(japply, {"params": tree}, vol,
                                      tile=32, batch=2)
    shapes = []

    def jax_tiles(x):
        shapes.append(tuple(x.shape))
        out = jm.apply({"params": tree}, jnp.asarray(nchw_to_nhwc(x)))
        return nhwc_to_nchw(np.asarray(out))

    got = P.sliding_window_inference(jax_tiles, vol, tile=32, batch=2,
                                     device="cpu")
    assert shapes == [(2, 1, 24, 24)] * 2
    np.testing.assert_array_equal(got, want)
    narrow = vol[:, :20]
    with pytest.raises(ValueError, match="operands could not be broadcast"):
        J.sliding_window_inference(japply, {"params": tree}, narrow,
                                   tile=32, batch=2)
    with pytest.raises(ValueError, match="clamps the 32² tile to 24x20"):
        P.sliding_window_inference(jax_tiles, narrow, tile=32, batch=2,
                                   device="cpu")
