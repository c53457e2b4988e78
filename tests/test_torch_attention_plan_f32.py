"""The f32 attention route above D = 64: which kernel of
``csrc/flash_attention.cu`` a shape and layout take and that kernel's
tiles, shared memory, registers and grid (``flash_attention.f32_plan``), on
the CPU; on the card (``gpu``) the library's own plan against this one and
the warp-specialised kernel ``tf32x3_ws`` against the plain version.

Card cases run with
``python -m pytest --noconftest -m gpu tests/test_torch_attention_plan_f32.py``
(this file does not import JAX)."""
import pytest
import torch

from dsdiff_torch.ops import flash_attention as PF

# registers a launch of 384 threads holds (168 a thread: 64,512 of the SM's
# 65,536), over a warpgroup's 128 threads: what setmaxnreg can share out
LAUNCH_REGS_PER_THREAD_OF_A_WARPGROUP = 504
# what a consumer thread holds beside O, the scores and Q's lo fragments:
# the softmax state, indices, addresses and descriptors
CONSUMER_OVERHEAD_REGS = 32


@pytest.mark.parametrize("lo, hi, atoms, keys, split", [
    (65, 96, 3, 64, False), (97, 128, 4, 64, False),
    (129, 192, 6, 64, False), (193, 256, 8, 32, False),
    (257, 384, 12, 32, True), (385, 512, 16, 32, True)])
def test_every_head_dim_above_64_takes_the_warp_specialised_kernel(
        lo, hi, atoms, keys, split):
    """64 < D <= 512 (TMA layouts, or the wrapper's copies of the others):
    two consumer warpgroups and a producer
    (384 threads), 128 Q rows a block (64 above D = 256, where the two
    consumers split O's columns), an 8-atom ring, everything under the
    block's shared-memory limit and every warpgroup within setmaxnreg's
    split of the SM's registers."""
    for D in range(lo, hi + 1):
        plan = PF.f32_plan(8, 1024, 4, D)
        assert plan["kernel"] == "tf32x3_ws", D
        assert plan["dk"] == 4 * atoms and 8 * plan["dk"] >= D
        assert (plan["consumers"], plan["threads"]) == (2, 384)
        assert plan["split"] == split and plan["key_rows"] == keys
        assert plan["q_rows"] == (64 if split else 128)
        assert plan["stages"] >= 3  # a consumer holds two atoms at most
        # Q's rows, the split's score exchange, the ring of raw + split atoms
        xbuf = 2 * 2 * 64 * keys * 4 if split else 0
        assert plan["smem_bytes"] == (plan["q_rows"] * atoms * 128 + xbuf
                                      + plan["stages"] * 2 * keys * 128
                                      + 1024)
        # the static mbarriers (Q's, and full, ready, empty a stage) beside
        assert plan["smem_bytes"] + 8 * (1 + 3 * plan["stages"]) <= PF.SMEM_LIMIT
        assert (plan["producer_regs"] + 2 * plan["consumer_regs"]
                <= LAUNCH_REGS_PER_THREAD_OF_A_WARPGROUP)
        assert plan["consumer_regs"] <= 255 and plan["consumer_regs"] % 8 == 0
        o_atoms = atoms // 2 if split else atoms
        assert plan["accumulator_regs"] == 16 * o_atoms + keys + 16
        assert (plan["accumulator_regs"] + CONSUMER_OVERHEAD_REGS
                <= plan["consumer_regs"]), D
        assert plan["grid"] == (1024 // plan["q_rows"], 32, 1)


@pytest.mark.parametrize("N", [1, 63, 64, 65, 127, 128, 129, 1000, 1024, 1025])
@pytest.mark.parametrize("D", [80, 192, 256, 512])
def test_warp_specialised_grid_covers_ragged_query_rows(N, D):
    """ceil(N / Q rows) blocks along x, one per batch and head along y."""
    plan = PF.f32_plan(3, N, 5, D)
    rows = plan["q_rows"]
    assert plan["grid"] == (-(-N // rows), 15, 1)
    assert (plan["grid"][0] - 1) * rows < N <= plan["grid"][0] * rows


@pytest.mark.parametrize("D", [1, 7, 16, 36, 48, 60, 64])
def test_head_dims_up_to_64_keep_their_instantiation(D):
    """D <= 64 keeps attn_fwd_tf32x3 on every layout: 64 Q rows, D padded
    to a multiple of 8, a two-stage cp.async ring of rows padded to
    8 * DK + 4 floats."""
    dk = -(-D // 8)
    assert PF.f32_plan(4, 1000, 6, D) == dict(
        kernel="tf32x3", dk=dk, q_rows=64, key_rows=64, stages=2,
        consumers=1, threads=128, smem_bytes=5 * 64 * (8 * dk + 4) * 4,
        grid=(16, 24, 1), split=False)


def _heads(B, N, H, D, stride, offset=0, device="cpu", gen=None):
    """[B, N, H, D] f32 cut from heads of ``stride`` floats, the buffer
    starting ``offset`` floats past an aligned address."""
    flat = torch.randn(offset + B * N * H * stride, generator=gen,
                       device=device)
    return flat[offset:].view(B, N, H, stride)[..., :D]


@pytest.mark.parametrize("D, stride, offset, dk, q_rows", [
    (65, 65, 0, 12, 128), (100, 102, 0, 16, 128), (192, 192, 1, 24, 128),
    (256, 258, 0, 32, 128), (300, 302, 0, 48, 64), (512, 512, 1, 64, 64)])
def test_layouts_no_tensor_map_describes_keep_the_mma_sync_kernels(
        D, stride, offset, dk, q_rows):
    """Above 64, a layout TMA cannot read (a head stride that is not a
    multiple of 4 floats, a base one float off) goes to tf32x3_ws as
    contiguous copies, rows padded to a multiple of 8 floats, which a
    tensor map describes: the plan of the TMA layouts."""
    q, k, v = [_heads(2, 200, 3, D, stride, offset)] * 3
    assert PF._f32_vec(q, k, v, (q.stride(),) * 3) == 1
    assert PF.f32_load(q, k, v) == "copy"
    copy = PF._tma_operand(q, -(-D // 8) * 8)[..., :D]
    assert torch.equal(copy, q) and PF._f32_vec(copy, copy, copy,
                                                (copy.stride(),) * 3) == 0
    assert PF.route(q, k, v) == "tf32x3_ws"
    plan = PF.f32_plan(2, 200, 3, D)
    assert (plan["kernel"], plan["dk"], plan["q_rows"]) == ("tf32x3_ws", dk,
                                                           q_rows)
    assert plan["grid"] == (-(-200 // q_rows), 6, 1)
    assert plan["smem_bytes"] <= PF.SMEM_LIMIT


@pytest.mark.parametrize("make, load, kernel", [
    # disc_diff / palette, the classifier, CLIP's image tower: qkv thirds
    (lambda: torch.zeros(4, 1024, 3, 4, 192).unbind(2), "tma", "tf32x3_ws"),
    (lambda: torch.zeros(4, 1024, 3, 4, 128).unbind(2), "tma", "tf32x3_ws"),
    (lambda: torch.zeros(4, 257, 3, 16, 80).unbind(2), "tma", "tf32x3_ws"),
    # the KL-VAE's one head of 512, separate projections
    (lambda: [torch.zeros(4, 1024, 1, 512)] * 3, "tma", "tf32x3_ws"),
    # dense heads a tensor map describes, D not a multiple of 4 included
    (lambda: [_heads(2, 64, 2, 65, 68)] * 3, "tma", "tf32x3_ws"),
    (lambda: [_heads(2, 64, 2, 500, 500)] * 3, "tma", "tf32x3_ws"),
    # what no tensor map describes: head strides of 65 and 130 floats, a
    # base one float past an aligned address; the wrapper copies them
    (lambda: torch.zeros(2, 64, 3, 2, 65).unbind(2), "copy", "tf32x3_ws"),
    (lambda: [_heads(2, 64, 2, 130, 130)] * 3, "copy", "tf32x3_ws"),
    (lambda: [_heads(2, 64, 2, 192, 192, 1)] * 3, "copy", "tf32x3_ws"),
    (lambda: [_heads(2, 64, 1, 300, 302)] * 3, "copy", "tf32x3_ws"),
    # D <= 64 is not this route's
    (lambda: torch.zeros(4, 1024, 3, 4, 48).unbind(2), "cp.async 16 B", "tf32x3"),
    (lambda: [_heads(4, 64, 8, 36, 36)] * 3, "cp.async 16 B", "tf32x3"),
])
def test_route_follows_the_layout(make, load, kernel):
    q, k, v = make()
    assert PF.f32_load(q, k, v) == load
    assert PF.route(q, k, v) == kernel


def test_only_a_layout_every_operand_shares_takes_the_tma_kernel():
    """q aligned and k, v one float off: the kernel needs all three, so
    the wrapper copies them; the kernel is the same."""
    q = _heads(1, 64, 2, 128, 128)
    k = v = _heads(1, 64, 2, 128, 128, 1)
    assert PF.f32_load(q, q, q) == "tma"
    assert PF.route(q, q, q) == "tf32x3_ws"
    assert PF.f32_load(q, k, v) == "copy"
    assert PF.route(q, k, v) == "tf32x3_ws"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

TOL = 2e-5  # chip_smoke.KERNEL_TOL[float32]
F32_WS_HEAD_DIMS = [65, 72, 80, 96, 100, 128, 136, 192, 200, 256, 264, 384,
                    500, 512]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda")


@pytest.mark.gpu
def test_library_plan_matches_the_wrappers_description():
    """``dsdiff_flash_attention_f32_plan`` in the built library against
    ``f32_plan`` at every head dim: kernel, Q rows, keys a tile, stages,
    threads, shared memory and grid."""
    _cuda()
    keys = ("kernel", "q_rows", "key_rows", "stages", "threads",
            "smem_bytes", "grid")
    for D in range(1, PF.MAX_HEAD_DIM + 1):
        want = PF.f32_plan(3, 1000, 5, D)
        got = PF.native_f32_plan(3, 1000, 5, D)
        assert got == {k: want[k] for k in keys}, D


@pytest.mark.gpu
@pytest.mark.parametrize("B, N, M, H", [(1, 130, 200, 2), (2, 1000, 77, 1),
                                        (1, 64, 1, 3), (2, 257, 257, 2)])
@pytest.mark.parametrize("D", F32_WS_HEAD_DIMS)
def test_cuda_warp_specialised_kernel_matches_plain_version(D, B, N, M, H):
    """``tf32x3_ws`` at every head dim it takes, q a strided third of one
    qkv tensor and k, v of another (heads padded to a multiple of 4
    floats, as a tensor map needs), N and M ragged against the 128- and
    64-row Q tiles and the 64- and 32-key tiles, M != N, one key, CLIP's
    257 tokens; within 2e-5 of the plain version, one launch."""
    g = _cuda().manual_seed(D * 10007 + N * 131 + M)
    padded = -(-D // 4) * 4
    q = torch.randn(B, N, 3, H, padded, generator=g,
                    device="cuda")[..., :D].unbind(2)[0]
    _, k, v = torch.randn(B, M, 3, H, padded, generator=g,
                          device="cuda")[..., :D].unbind(2)
    assert PF.route(q, k, v) == "tf32x3_ws"
    before = PF.LAUNCHES
    got = PF.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert PF.LAUNCHES == before + 1
    want = PF.reference_attention(q, k, v)
    err = (got - want).abs().max().item()
    assert got.shape == (B, N, H, D) and err <= TOL, (D, N, M, err)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [80, 192, 512])
def test_cuda_warp_specialised_kernel_with_one_hot_v_returns_p(D):
    """v[m] = e_(m mod D): out[n, d] sums P[n, m] over the keys m = d mod
    D, so a key that V^T's in-place transpose or P's A fragment put in
    another order than S's accumulator moves its mass to another column."""
    g = _cuda().manual_seed(D)
    B, N, M, H = 2, 130, 300, 2
    q = torch.randn(B, N, H, D, generator=g, device="cuda")
    k = torch.randn(B, M, H, D, generator=g, device="cuda")
    onehot = torch.eye(D, device="cuda")[torch.arange(M, device="cuda") % D]
    v = onehot[None, :, None, :].expand(B, M, H, D).contiguous()
    assert PF.route(q, k, v) == "tf32x3_ws"
    got = PF.flash_attention(q, k, v)
    torch.cuda.synchronize()
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) / D**0.5
    want = torch.einsum("bhnm,md->bnhd", torch.softmax(s, -1), onehot)
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("D, stride, offset", [
    (65, 65, 0), (130, 130, 0), (192, 192, 1), (300, 302, 0), (512, 512, 1)])
def test_cuda_layouts_no_tensor_map_describes_take_the_planned_kernel(
        D, stride, offset):
    """Above 64, layouts TMA cannot read launch the kernel ``f32_plan``
    names, tf32x3_ws, on the wrapper's copies, at ragged N and M: one
    launch, the same bits as the kernel on the caller's own contiguous
    copies, and within 2e-5 of the plain version."""
    g = _cuda().manual_seed(D + stride + offset)
    q = _heads(2, 130, 2, D, stride, offset, "cuda", g)
    k = _heads(2, 77, 2, D, stride, offset, "cuda", g)
    v = _heads(2, 77, 2, D, stride, offset, "cuda", g)
    assert PF.f32_load(q, k, v) == "copy"
    assert PF.route(q, k, v) == "tf32x3_ws"
    before = PF.LAUNCHES
    got = PF.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert PF.LAUNCHES == before + 1
    same = PF.flash_attention(*(x.contiguous() for x in (q, k, v)))
    assert torch.equal(got, same)
    want = PF.reference_attention(q, k, v)
    assert (got - want).abs().max().item() <= TOL
