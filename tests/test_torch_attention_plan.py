"""The bf16 attention route's host side, on the CPU: which kernel of
``csrc/flash_attention.cu`` a shape and layout take, and that kernel's tiles,
shared memory and grid (``flash_attention.bf16_plan``). The library's own
description of the same launches is held against this one on the card
(``test_torch_flash_attention.py``, ``gpu``)."""
import pytest
import torch

from dsdiff_torch.ops import flash_attention as PF


@pytest.mark.parametrize("lo, hi", [(65, 128), (129, 192), (193, 256)])
def test_every_head_dim_above_64_takes_the_warp_specialised_kernel(lo, hi):
    """64 < D <= 256 (TMA layouts, or the wrapper's copies of the others):
    128 Q rows a block, two consumer
    warpgroups and a producer (384 threads), two stages in each of the K
    and V rings, every tile under the block's shared-memory limit, and a
    grid of ceil(N / 128) x B*H blocks."""
    na = -(-hi // 64)
    for D in range(lo, hi + 1):
        plan = PF.bf16_plan(8, 1024, 4, D)
        assert plan["kernel"] == "wgmma_ws" and plan["atoms"] == na
        assert (plan["q_rows"], plan["consumers"], plan["threads"]) == (128, 2, 384)
        assert plan["stages"] >= 2
        # Q's 128 rows, then two K and two V tiles of 64 rows
        assert plan["smem_bytes"] == (2 + 2 * 2) * na * 8192 + 1024
        assert plan["smem_bytes"] <= PF.SMEM_LIMIT
        assert plan["grid"] == (8, 32, 1)


@pytest.mark.parametrize("N, blocks", [(1, 1), (64, 1), (127, 1), (128, 1),
                                       (129, 2), (1000, 8), (1024, 8),
                                       (1025, 9)])
def test_warp_specialised_grid_covers_ragged_query_rows(N, blocks):
    assert PF.bf16_plan(3, N, 5, 192)["grid"] == (blocks, 15, 1)


@pytest.mark.parametrize("D", [1, 16, 36, 48, 64])
def test_head_dims_up_to_64_keep_their_instantiation(D):
    """One warpgroup a 64-row Q tile, a two-stage ring in 41,984 bytes,
    grid ceil(N / 64) x B*H, on every layout (the threads load what no TMA
    map describes): the kernel the flagship's D = 48 has run since it was
    redesigned for Hopper."""
    assert PF.bf16_plan(4, 1000, 6, D) == dict(
        kernel="wgmma", atoms=1, o_atoms=1, q_rows=64, stages=2,
        consumers=1, threads=128, smem_bytes=41984, grid=(16, 24, 1))


@pytest.mark.parametrize("D, atoms, smem", [(257, 6, 123904), (384, 6, 123904),
                                            (385, 8, 164864), (512, 8, 164864)])
def test_head_dims_above_256_keep_their_two_block_tiles(D, atoms, smem):
    """Above 256 a 64-row Q tile takes two blocks (grid z), each owning
    half of O's columns, one stage of Q, K and half of V."""
    assert PF.bf16_plan(1, 1024, 1, D) == dict(
        kernel="wgmma", atoms=atoms, o_atoms=atoms // 2, q_rows=64,
        stages=1, consumers=1, threads=128, smem_bytes=smem,
        grid=(16, 1, 2))


def _dense_heads(B, N, H, D, stride=None, offset=0):
    stride = D if stride is None else stride
    flat = torch.zeros(offset + B * N * H * stride, dtype=torch.bfloat16)
    return flat[offset:].view(B, N, H, stride)[..., :D]


@pytest.mark.parametrize("vec", [4, 2, 1])
@pytest.mark.parametrize("D, atoms", [(72, 2), (128, 2), (192, 3), (256, 4)])
def test_thread_loaded_layouts_above_64_keep_the_one_warpgroup_kernel(
        D, atoms, vec):
    """Above 64, layouts whose tiles the threads could load (``vec`` 4, 2
    or 1: a head stride of D + 4 or D + 2 elements, a base 2 bytes off) go
    to the TMA kernel as contiguous copies, rows padded to a multiple of 8
    elements, which a tensor map describes: wgmma_ws's 128 Q rows, two K/V
    stages of NA-atom tiles."""
    stride, offset = (D + 4, 0) if vec == 4 else (D + 2, 0) if vec == 2 else (D, 1)
    q, k, v = [_dense_heads(2, 200, 3, D, stride, offset)] * 3
    assert PF._vec(q, k, v, (q.stride(),) * 3) == vec
    assert PF.bf16_load(q, k, v) == "copy"
    copy = PF._tma_operand(q, -(-D // 8) * 8)[..., :D]
    assert torch.equal(copy, q) and PF._vec(copy, copy, copy,
                                            (copy.stride(),) * 3) == 0
    assert PF.route(q, k, v) == "wgmma_ws"
    assert PF.bf16_plan(2, 200, 3, D) == dict(
        kernel="wgmma_ws", atoms=atoms, o_atoms=atoms, q_rows=128, stages=2,
        consumers=2, threads=384, smem_bytes=6 * atoms * 8192 + 1024,
        grid=(2, 6, 1))


@pytest.mark.parametrize(
    "make, load, kernel",
    [
        # disc_diff / palette and the classifier: qkv thirds, TMA
        (lambda: torch.zeros(4, 1024, 3, 4, 192, dtype=torch.bfloat16).unbind(2),
         "tma", "wgmma_ws"),
        (lambda: torch.zeros(4, 1024, 3, 4, 128, dtype=torch.bfloat16).unbind(2),
         "tma", "wgmma_ws"),
        (lambda: [_dense_heads(4, 1024, 16, 72)] * 3, "tma", "wgmma_ws"),
        # the flagship's D = 48 and the fusion's D = 36 are not this route's
        (lambda: torch.zeros(4, 1024, 3, 4, 48, dtype=torch.bfloat16).unbind(2),
         "tma", "wgmma"),
        (lambda: [_dense_heads(4, 64, 8, 36)] * 3, "cp.async 8 B", "wgmma"),
        # above 64, layouts no tensor map describes: the wrapper's copies
        # go to the same kernel
        (lambda: [_dense_heads(2, 64, 2, 100)] * 3, "copy", "wgmma_ws"),
        (lambda: [_dense_heads(2, 64, 2, 72, 76)] * 3, "copy", "wgmma_ws"),
        (lambda: [_dense_heads(2, 64, 2, 130)] * 3, "copy", "wgmma_ws"),
        (lambda: [_dense_heads(2, 64, 2, 192, 200, 1)] * 3, "copy", "wgmma_ws"),
        # f32 on a layout no tensor map describes (a head stride of 194
        # floats) takes tf32x3_ws on its copy, as TMA layouts do
        # (test_torch_attention_plan_f32.py)
        (lambda: [torch.zeros(2, 64, 2, 194, dtype=torch.float32)[..., :192]] * 3,
         None, "tf32x3_ws"),
    ],
)
def test_route_follows_the_layout(make, load, kernel):
    """The wrapper's load choice (``_vec``) is the one it made before the
    warp-specialised kernel existed up to D = 64; above it a layout no
    tensor map describes is copied, and the route is the kernel that
    runs."""
    q, k, v = make()
    if load is not None:
        assert PF.bf16_load(q, k, v) == load
    assert PF.route(q, k, v) == kernel
