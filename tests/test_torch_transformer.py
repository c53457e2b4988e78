"""The port's transformer conditioning path against the JAX package's, on
the CPU: the attention modules, the backbone with spatial transformers
(dot-product and FFT), DSUNet's cross-attention fusion in both stream
layouts, and a UNet driven through ``conditioned_call``'s context modes.
Inputs and weights are numpy from a seed, every leaf random; the Flax trees
go into the port through ``utils.flax_bridge``. f32 outputs agree to 1e-4
of max(1, max |out|); the FFT paths to 2e-4 (two FFTs and an irfft of
another library's rounding sit before the softmax)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.models import attention as JA
from dsdiff_tpu.models.dsunet import DSUNet as JDSUNet
from dsdiff_tpu.models.unet import UNet as JUNet
from dsdiff_tpu.models.wrapper import conditioned_call as j_conditioned_call
from dsdiff_torch.models import attention as PA
from dsdiff_torch.models import build_model
from dsdiff_torch.models.wrapper import conditioned_call
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict
from torch_parity_utils import one_thread, random_flax_params

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL = 1e-4
FFT_RTOL = 2e-4

TINY = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2,),
            channel_mult=(1, 2), use_scale_shift_norm=True)


def _arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, rtol=RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _pair(jmod, pmod, seed, *args, **kw):
    """Init ``jmod`` on ``args``, fill every leaf from ``seed``, load the
    tree into ``pmod``; returns (JAX output, port output)."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    params = jmod.init(jax.random.PRNGKey(0), *jargs, **kw)
    params = random_flax_params(params["params"], seed)
    want = jmod.apply({"params": params}, *jargs, **kw)
    pmod.load_state_dict(flax_to_state_dict(params, pmod))
    pmod.eval()
    with torch.no_grad():
        got = pmod(*[None if a is None else torch.from_numpy(a)
                     for a in args], **kw)
    return want, got


def test_cross_attention_with_more_keys_than_queries_at_head_dim_36():
    """M = 7 context tokens of width 20 against N = 10 queries, two heads
    of 36 (the fusion's head width at C = 96); and self-attention."""
    rng = np.random.default_rng(0)
    x, ctx = _arr(rng, 2, 10, 24), _arr(rng, 2, 7, 20)
    jm = JA.CrossAttention(heads=2, dim_head=36)
    want, got = _pair(jm, PA.CrossAttention(24, 20, heads=2, dim_head=36),
                      1, x, ctx)
    _close(got, want, what="cross")
    want, got = _pair(jm, PA.CrossAttention(24, heads=2, dim_head=36), 2, x)
    _close(got, want, what="self")


@pytest.mark.parametrize("M", [6, 24])
def test_fft_attention_crops_the_key_axis_as_jax_irfft(M):
    """D = 8: rfft gives 5 bins. The irfft over the key axis (n = M) crops
    its input to M // 2 + 1 entries; M on both sides of 2 * (D // 2 + 1)."""
    rng = np.random.default_rng(M)
    x, ctx = _arr(rng, 2, 5, 16), _arr(rng, 2, M, 12)
    want, got = _pair(JA.FFTAttention(heads=2, dim_head=8),
                      PA.FFTAttention(16, 12, heads=2, dim_head=8), 3, x, ctx)
    _close(got, want, FFT_RTOL)


def test_fft_attention_irfft_matches_numpy_on_a_longer_input():
    """torch.fft.irfft and jnp.fft.irfft crop a longer input alike."""
    rng = np.random.default_rng(5)
    z = _arr(rng, 3, 9) + 1j * _arr(rng, 3, 9)
    for n in (4, 7, 16):
        want = np.asarray(jnp.fft.irfft(jnp.asarray(z), n=n, axis=-1))
        got = torch.fft.irfft(torch.from_numpy(z.astype(np.complex64)), n=n,
                              dim=-1)
        _close(got, want, FFT_RTOL, what=f"n={n}")


@pytest.mark.parametrize("glu", [True, False])
def test_feed_forward_both_forms_with_tanh_gelu(glu):
    rng = np.random.default_rng(6)
    x = _arr(rng, 2, 5, 16)
    want, got = _pair(JA.FeedForward(glu=glu), PA.FeedForward(16, glu=glu),
                      4, x)
    _close(got, want)


@pytest.mark.parametrize("disable_self_attn", [False, True])
def test_basic_transformer_block(disable_self_attn):
    rng = np.random.default_rng(7)
    x, ctx = _arr(rng, 2, 9, 24), _arr(rng, 2, 5, 12)
    jm = JA.BasicTransformerBlock(heads=2, dim_head=12,
                                  disable_self_attn=disable_self_attn)
    pm = PA.BasicTransformerBlock(24, heads=2, dim_head=12,
                                  disable_self_attn=disable_self_attn,
                                  context_dim=12)
    want, got = _pair(jm, pm, 5, x, ctx)
    _close(got, want)


@pytest.mark.parametrize("depth, use_fft", [(1, False), (2, False),
                                            (1, True)])
def test_spatial_transformer_on_an_nchw_map(depth, use_fft):
    """Tokens in the JAX package's [B, H*W, C] order: the port's NCHW map
    in, its output permuted back, against the NHWC module."""
    rng = np.random.default_rng(8)
    x, ctx = _arr(rng, 2, 4, 3, 32), _arr(rng, 2, 6, 10)
    jm = JA.SpatialTransformer(depth=depth, heads=2, dim_head=16,
                               use_fft=use_fft)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ctx))
    params = random_flax_params(params["params"], 9)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx))
    pm = PA.SpatialTransformer(32, depth=depth, heads=2, dim_head=16,
                               use_fft=use_fft, context_dim=10)
    pm.load_state_dict(flax_to_state_dict(params, pm))
    with torch.no_grad():
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2),
                 torch.from_numpy(ctx)).permute(0, 2, 3, 1)
    _close(got, want, FFT_RTOL if use_fft else RTOL)


@pytest.mark.parametrize("extra, rtol", [
    (dict(num_head_channels=16, use_spatial_transformer=True), RTOL),
    (dict(num_heads=2, use_spatial_transformer=True, transformer_depth=2),
     RTOL),
    (dict(num_head_channels=16, use_spatial_transformer=True,
          use_fft_attention=True), FFT_RTOL),
])
def test_backbone_with_spatial_transformers(extra, rtol):
    """Every attention block of the UNet's encoder, middle and decoder a
    SpatialTransformer (without a context its second attention attends over
    the map as well), dot-product or FFT."""
    rng = np.random.default_rng(10)
    x = _arr(rng, 2, 16, 16, 4)
    t = np.array([3.0, 742.0], np.float32)
    jm = JUNet(in_channels=4, out_channels=2, **TINY, **extra)
    pm = build_model("unet", device="cpu", in_channels=4, out_channels=2,
                     **TINY, **extra)
    want, got = _pair(jm, pm, 11, x, t)
    _close(got, want, rtol)


@pytest.mark.parametrize("stream_mode", ["sequential", "vmap"])
def test_dsunet_cross_attention_fusion_and_features(stream_mode):
    """``fusion='crossattn'``: the four SE-projected features as context
    tokens of a depth-4 ``fusion_attn`` over the noise stream's bottleneck
    (4 heads of 16 at conv_ch 64), both stream layouts; the output and
    every feature group."""
    rng = np.random.default_rng(12)
    x = _arr(rng, 2, 16, 16, 4)
    t = np.array([3.0, 742.0], np.float32)
    kw = dict(TINY, num_heads=4, fusion="crossattn", stream_mode=stream_mode)
    jm = JDSUNet(in_channels=4, out_channels=2, **kw)
    pm = build_model("dsunet", device="cpu", in_channels=4, out_channels=2,
                     **kw)
    assert pm.fusion_attn.block_3.attn2.to_k.in_features == 32
    assert not hasattr(pm, "all_proj")
    (want, want_feats), (got, got_feats) = _pair(jm, pm, 13, x, t)
    _close(got, want, what="out")
    assert set(got_feats) == set(want_feats)
    for name, w in want_feats.items():
        _close(got_feats[name], w, what=name)


def test_stacked_encoders_hold_their_transformers_per_stream():
    """``stream_mode='vmap'`` with spatial transformers: every transformer
    leaf under ``encoders`` carries the leading [4] stream axis (LayerNorm
    scales and biases included) and runs on its stream's slice."""
    rng = np.random.default_rng(16)
    x = _arr(rng, 2, 16, 16, 4)
    t = np.array([3.0, 742.0], np.float32)
    kw = dict(TINY, num_head_channels=16, use_spatial_transformer=True,
              stream_mode="vmap")
    jm = JDSUNet(in_channels=4, out_channels=2, **kw)
    pm = build_model("dsunet", device="cpu", in_channels=4, out_channels=2,
                     **kw)
    norm = pm.encoders.down_1_0_attn.block_0.norm1.weight
    assert norm.shape == (4, 64)
    (want, _), (got, _) = _pair(jm, pm, 17, x, t)
    _close(got, want)


def _from_torch(tensor: torch.Tensor, leaf: str, ndim: int) -> np.ndarray:
    """A port parameter back in the Flax layout of a leaf of rank ``ndim``."""
    arr = tensor.detach().numpy()
    if leaf != "kernel":
        return arr
    axes = {2: (1, 0), 4: (2, 3, 1, 0), 3: (0, 2, 1), 5: (0, 3, 4, 2, 1)}
    return arr.transpose(axes[ndim])


@pytest.mark.parametrize("name", ["unet", "dsunet_vmap", "classifier",
                                  "class_embedder"])
def test_bridge_round_trip_of_the_transformer_path_leaves(name):
    """Flax tree -> port state_dict -> back: every leaf (LayerNorm
    ``scale``/``bias``, ``Embed``'s ``embedding``, the stacked layout's
    transformer kernels, ``pool_query``) returns bit for bit, as f32."""
    from dsdiff_tpu.models.encoder_unet import EncoderUNet as JEncoderUNet
    from dsdiff_tpu.models.encoders import ClassEmbedder as JClassEmbedder
    from dsdiff_torch.models.encoder_unet import EncoderUNet
    from dsdiff_torch.models.encoders import ClassEmbedder
    from dsdiff_torch.utils.flax_bridge import flatten_tree

    x = np.zeros((1, 16, 16, 1), np.float32)
    t = np.zeros((1,), np.float32)
    y = np.zeros((1,), np.int32)
    st = dict(TINY, num_head_channels=16, use_spatial_transformer=True)
    if name == "unet":
        jm, args = JUNet(in_channels=1, num_classes=3, **st), (x, t, None, y)
        pm = build_model("unet", device="cpu", num_classes=3, **st)
    elif name == "dsunet_vmap":
        x = np.zeros((1, 16, 16, 4), np.float32)
        jm, args = JDSUNet(stream_mode="vmap", **st), (x, t)
        pm = build_model("dsunet", device="cpu", stream_mode="vmap", **st)
    elif name == "classifier":
        jm, args = JEncoderUNet(pool="attention", model_channels=32,
                                channel_mult=(1, 2)), (x, t)
        pm = EncoderUNet(pool="attention", model_channels=32,
                         channel_mult=(1, 2))
    else:
        jm, args = JClassEmbedder(n_classes=4, embed_dim=8), (y,)
        pm = ClassEmbedder(4, 8)
    tree = random_flax_params(jm.init(jax.random.PRNGKey(0), *[
        None if a is None else jnp.asarray(a) for a in args])["params"], 18)
    pm.load_state_dict(flax_to_state_dict(tree, pm))
    state = pm.state_dict()
    flat = flatten_tree(tree)
    for path, want in flat.items():
        *mods, leaf = path.split("/")
        key = ".".join(mods + [{"kernel": "weight", "scale": "weight",
                                "embedding": "weight"}.get(leaf, leaf)])
        np.testing.assert_array_equal(  # the port's parameters are f32
            _from_torch(state[key], leaf, want.ndim), want.astype(np.float32),
            err_msg=path)
    assert len(flat) == len(state)


@pytest.mark.parametrize("mode", ["crossattn", "hybrid", "crossattn-adm"])
def test_unet_through_conditioned_call_reads_the_context(mode):
    """A UNet with spatial transformers whose second attentions take the
    joined ``c_crossattn`` (two lists of 3 and 4 tokens of width 12) as
    context; ``hybrid`` joins ``c_concat`` to x, ``crossattn-adm`` adds the
    adm vector to the time embedding."""
    rng = np.random.default_rng(14)
    x = _arr(rng, 2, 16, 16, 1)
    t = np.array([3.0, 742.0], np.float32)
    cond = {"c_crossattn": [_arr(rng, 2, 3, 12), _arr(rng, 2, 4, 12)],
            "c_concat": [_arr(rng, 2, 16, 16, 2)],
            "c_adm": _arr(rng, 2, 6)}
    in_ch = 3 if mode == "hybrid" else 1
    extra = dict(adm_in_channels=6) if mode == "crossattn-adm" else {}
    kw = dict(TINY, num_head_channels=16, use_spatial_transformer=True,
              **extra)
    jm = JUNet(in_channels=in_ch, out_channels=2, **kw)
    jcond = {k: ([jnp.asarray(a) for a in v] if isinstance(v, list)
                 else jnp.asarray(v)) for k, v in cond.items()}
    params = {}

    def japply(*args, **kws):
        if not params:
            params.update(random_flax_params(
                jm.init(jax.random.PRNGKey(0), *args, **kws)["params"], 15))
        return jm.apply({"params": params}, *args, **kws)

    want = j_conditioned_call(japply, mode, jnp.asarray(x), jnp.asarray(t),
                              jcond)
    pm = build_model("unet", device="cpu", in_channels=in_ch, out_channels=2,
                     context_dim=12, **kw).eval()
    pm.load_state_dict(flax_to_state_dict(params, pm))
    pcond = {k: ([torch.from_numpy(a) for a in v] if isinstance(v, list)
                 else torch.from_numpy(v)) for k, v in cond.items()}
    with torch.no_grad():
        got = conditioned_call(pm, mode, torch.from_numpy(x),
                               torch.from_numpy(t), pcond)
        without = conditioned_call(pm, mode, torch.from_numpy(x),
                                   torch.from_numpy(t),
                                   dict(pcond, c_crossattn=[
                                       torch.zeros(2, 7, 12)]))
    _close(got, want)
    assert (got - without).abs().max() > 1e-3  # the context is read
