"""The ResBlock norm site's op, ``ops.group_norm_film_silu``, on a card.

Marked ``gpu``: each test skips where there is no CUDA device. No JAX is
imported, so on the card's machine it runs with
``python -m pytest --noconftest -m gpu tests/test_torch_norm_film_gpu.py``.

- The kernels against the plain version at the flagship's and DisC-Diff's
  widths and groups (C from 96 to 1536, 3 to 48 channels a group, maps 8²
  to 256², batch 1 and 8), with and without the FiLM, NCHW and channels
  last, f32 and bf16, plus a ragged map (H·W = 35, one element a load) and
  an x whose start is not 16-byte aligned. f32 to 1e-5 of max(1, max |y|);
  bf16 to one bf16 ulp of the plain version's f32 result (and the f32
  tolerance beside it: the two f32 results differ by the statistics' sum
  order). Two calls give bitwise-equal output; y keeps x's memory format.
- A bf16 ``ResBlock`` and a full-width bf16 flagship forward under
  ``torch.inference_mode`` (the op) against the same module with a
  gradient recorded (the eager chain), within the card's bf16 forward
  tolerance, 2e-2 of max(1, max |out|).
- A grad-enabled ``ResBlock`` launches none of the op's kernels.
"""
import pytest
import torch

from dsdiff_torch import ops
from dsdiff_torch.models import build_model
from dsdiff_torch.models.layers import GroupNorm32, ResBlock
from dsdiff_torch.ops import fused_norm as PF
from dsdiff_torch.utils.flax_bridge import random_params

# (B, C, H, W): the serving cells' sites (flagship C 96-576, DisC-Diff to
# 1536), batch 8 and 1, and a ragged map with GroupNorm32's 20 groups
SHAPES = [(8, 96, 256, 256), (8, 192, 256, 256), (1, 96, 256, 256),
          (8, 288, 128, 128), (8, 192, 64, 64), (1, 384, 64, 64),
          (8, 480, 32, 32), (8, 768, 32, 32), (8, 1536, 32, 32),
          (8, 576, 16, 16), (8, 288, 8, 8), (1, 768, 8, 8), (2, 40, 5, 7)]
F32_TOL = 1e-5
FORWARD_TOL = 2e-2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(B, C, H, W, dtype, layout, film, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(B, C, H, W, generator=g, device="cuda") * 2.0 + 0.5)
    x = x.to(dtype)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    gamma = torch.randn(C, generator=g, device="cuda") * 0.1 + 1.0
    beta = torch.randn(C, generator=g, device="cuda") * 0.1
    scale = shift = None
    if film:  # the halves of a [B, 2C, 1, 1] map, as ResBlock chunks them
        emb = (torch.randn(B, 2 * C, 1, 1, generator=g, device="cuda")
               * 0.3).to(dtype)
        scale, shift = emb.chunk(2, dim=1)
    return x, gamma, beta, scale, shift


def _groups(C):
    return GroupNorm32(C).norm.num_groups


def _hold(got, x, gamma, beta, G, scale, shift):
    """got against the plain version: f32 to F32_TOL, bf16 to one bf16 ulp
    of the plain f32 result plus F32_TOL."""
    f32 = lambda t: None if t is None else t.float()  # noqa: E731
    want = PF.group_norm_film_silu_plain(x.float(), gamma, beta, G,
                                         f32(scale), f32(shift))
    top = max(1.0, want.abs().max().item())
    err = (got.float() - want).abs()
    if x.dtype == torch.float32:
        assert err.max().item() <= F32_TOL * top, err.max().item()
        return
    exp = torch.floor(torch.log2(want.abs().clamp_min(2.0**-126)))
    ulp = torch.exp2(exp - 7)
    over = err - (ulp + F32_TOL * top)
    assert over.max().item() <= 0, (err.max().item(), over.max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("film", [True, False], ids=["film", "plain_norm"])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernels_match_plain_version(shape, dtype, layout, film):
    _card()
    x, gamma, beta, scale, shift = _inputs(*shape, dtype, layout, film)
    G = _groups(shape[1])
    with torch.inference_mode():
        got = ops.group_norm_film_silu(x, gamma, beta, G, scale, shift)
        again = ops.group_norm_film_silu(x, gamma, beta, G, scale, shift)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    assert got.stride() == x.stride()
    assert torch.equal(got, again)
    _hold(got, x, gamma, beta, G, scale, shift)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_unaligned_start_takes_element_loads(layout):
    """x one bf16 element past a 16-byte boundary: the kernels load one
    element at a time and give the plain version's output all the same."""
    _card()
    x0, gamma, beta, scale, shift = _inputs(2, 96, 16, 16, torch.bfloat16,
                                            layout, True)
    flat = torch.empty(x0.numel() + 1, dtype=x0.dtype, device="cuda")
    x = flat[1:].view(2, 16, 16, 96).permute(0, 3, 1, 2)
    if layout == "nchw":
        x = flat[1:].view(x0.shape)
    x.copy_(x0)
    assert x.data_ptr() % 16 and x.stride() == x0.stride()
    with torch.inference_mode():
        got = ops.group_norm_film_silu(x, gamma, beta, 32, scale, shift)
    torch.cuda.synchronize()
    _hold(got, x, gamma, beta, 32, scale, shift)


@pytest.mark.gpu
@pytest.mark.parametrize("shape, layout, launches", [
    ((8, 288, 8, 8), "nchw", 1), ((8, 96, 256, 256), "nchw", 2),
    ((8, 288, 8, 8), "channels_last", 2)])
def test_launches_per_call(shape, layout, launches):
    """One launch where a (batch, group) is one chunk, else two."""
    _card()
    x, gamma, beta, scale, shift = _inputs(*shape, torch.bfloat16, layout,
                                           True)
    before = PF.LAUNCHES
    with torch.inference_mode():
        ops.group_norm_film_silu(x, gamma, beta, 32, scale, shift)
    assert PF.LAUNCHES == before + launches


def _resblock(C, out, dtype, seed=0):
    block = ResBlock(C, 64, out, use_scale_shift_norm=True, dtype=dtype)
    return random_params(block, seed).cuda().eval()


def _rel_err(a, b):
    return ((a.float() - b.float()).abs().max()
            / max(1.0, b.float().abs().max().item())).item()


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("C, out, H", [(96, 96, 64), (192, 288, 32),
                                       (576, 288, 16)])
def test_resblock_op_against_eager_chain(C, out, H, layout):
    """bf16, the op under inference_mode against the eager chain (the same
    block with a gradient recorded): the op's sites count in
    ``model.norm_fused`` and launch kernels, the eager ones do not."""
    _card()
    block = _resblock(C, out, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(8, C, H, H, generator=g, device="cuda").bfloat16()
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    emb = torch.randn(8, 64, generator=g, device="cuda")
    before = PF.LAUNCHES
    eager = block(x, emb)
    torch.cuda.synchronize()
    assert PF.LAUNCHES == before  # grad-enabled: no kernel of the op
    with torch.inference_mode():
        fused = block(x, emb)
    torch.cuda.synchronize()
    assert PF.LAUNCHES > before
    assert fused.dtype == eager.dtype and fused.shape == eager.shape
    assert _rel_err(fused, eager) <= FORWARD_TOL


@pytest.mark.gpu
def test_flagship_forward_op_against_eager_chain():
    """The full-width bf16 flagship DSUNet (random weights), batch 2 at
    64²: 137 norm sites through the op under inference_mode against the
    eager chain with a gradient recorded."""
    _card()
    from chip_smoke import FLAGSHIP_CONFIG

    params = FLAGSHIP_CONFIG["unet_config"]["params"]
    model = build_model("dsunet", device="cuda", in_channels=4,
                        out_channels=2, dtype=torch.bfloat16, **params).eval()
    random_params(model, 0)
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(2, 64, 64, 4, generator=g, device="cuda")
    t = torch.tensor([17.0, 803.0], device="cuda")
    eager, _ = model(x, t)
    before = PF.LAUNCHES
    with torch.inference_mode():
        fused, _ = model(x, t)
    torch.cuda.synchronize()
    assert PF.LAUNCHES - before >= 137
    assert torch.isfinite(fused).all()
    assert _rel_err(fused, eager.detach()) <= FORWARD_TOL
