"""``dsdiff_torch.train.surgery`` against the JAX package's on the same
numpy trees: both are pure numpy, so results are equal bit for bit. A
converted tree then loads into the port's model of the other layout and
gives the same forward (1e-5 absolute: the same operations in another
grouping)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsdiff_tpu.models.dsunet import DSUNet as JDSUNet
from dsdiff_tpu.train import surgery as JSurg
from dsdiff_torch.models import build_model
from dsdiff_torch.train import surgery as PSurg
from dsdiff_torch.utils.flax_bridge import flatten_tree, flax_to_state_dict
from torch_parity_utils import TINY, random_flax_params


def _assert_trees_equal(got, want):
    got, want = flatten_tree(got), flatten_tree(want)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _flax_params(stream_mode, use_edge=False, seed=7):
    in_ch = 5 if use_edge else 4
    jm = JDSUNet(in_channels=in_ch, out_channels=2, stream_mode=stream_mode,
                 use_edge=use_edge, **TINY)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, in_ch)),
                     jnp.zeros((1,)))["params"]
    return random_flax_params(params, seed)


@pytest.mark.parametrize("old, new", [
    ((4, 3, 3, 3), (4, 3, 3, 3)),     # same shape: a copy
    ((8, 4, 3, 3), (8, 1, 3, 3)),     # fewer input channels
    ((8, 1, 3, 3), (16, 4, 3, 3)),    # more of both, counted use
    ((6,), (10,)),                    # rank 1: modulo-cycling
    ((4, 4), (2, 3, 5)),              # rank change: flatten-cycle
    ((4, 3, 3, 3), (4, 3, 5, 5)),     # trailing mismatch
])
def test_fit_tensor_matches_jax(old, new):
    arr = np.random.default_rng(0).standard_normal(old).astype(np.float32)
    got = PSurg.fit_tensor(arr, new)
    want = JSurg.fit_tensor(arr, new)
    assert got.shape == tuple(new) and got.dtype == arr.dtype
    np.testing.assert_array_equal(got, want)
    if old == new:
        assert got is not arr


def _two_trees():
    rng = np.random.default_rng(1)

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    loaded = {"enc": {"conv": {"kernel": a(3, 3, 4, 8), "bias": a(8)},
                      "extra": {"kernel": a(2, 2)}},
              "head": [{"kernel": a(8, 4)}, {"kernel": a(4, 4)}],
              "out": {"kernel": a(8, 2)}}
    target = {"enc": {"conv": {"kernel": a(3, 3, 1, 8), "bias": a(8)},
                      "fresh": {"scale": a(8)}},
              "head": [{"kernel": a(8, 4)}, {"kernel": a(4, 6)}],
              "out": {"kernel": a(8, 2)}}
    return loaded, target


def test_make_it_fit_matches_jax():
    loaded, target = _two_trees()
    got = PSurg.make_it_fit(loaded, target)
    _assert_trees_equal({"t": got["enc"]}, {"t": JSurg.make_it_fit(
        loaded, target)["enc"]})
    want = JSurg.make_it_fit(loaded, target)
    assert isinstance(got["head"], list)
    for g, w in zip(got["head"], want["head"]):
        np.testing.assert_array_equal(g["kernel"], w["kernel"])
    np.testing.assert_array_equal(got["enc"]["fresh"]["scale"],
                                  target["enc"]["fresh"]["scale"])
    assert got["enc"]["conv"]["kernel"].shape == (3, 3, 1, 8)
    assert "extra" not in got["enc"]


@pytest.mark.parametrize("ignore", [(), ("out",), ("enc/conv", "head/0")])
def test_filtered_load_matches_jax(ignore):
    loaded, target = _two_trees()
    got = PSurg.filtered_load(loaded, target, ignore)
    want = JSurg.filtered_load(loaded, target, ignore)
    for path in (("enc", "conv", "kernel"), ("enc", "conv", "bias"),
                 ("enc", "fresh", "scale"), ("head", 0, "kernel"),
                 ("head", 1, "kernel"), ("out", "kernel")):
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    # a mismatched shape keeps the target's init; an ignored prefix too
    np.testing.assert_array_equal(got["enc"]["conv"]["kernel"],
                                  target["enc"]["conv"]["kernel"])
    kept = target if "out" in ignore else loaded
    np.testing.assert_array_equal(got["out"]["kernel"], kept["out"]["kernel"])


@pytest.mark.parametrize("stream_mode", ["sequential", "vmap"])
def test_convert_stream_layout_matches_jax_and_round_trips(stream_mode):
    params = _flax_params(stream_mode)
    got = PSurg.convert_stream_layout(params)
    _assert_trees_equal(got, JSurg.convert_stream_layout(params))
    if stream_mode == "sequential":
        assert "encoders" in got and "encoder_0" not in got
        assert got["encoders"]["in_conv"]["kernel"].shape == (4, 3, 3, 1, 32)
    else:
        assert "encoders" not in got
        assert [k for k in sorted(got) if k.startswith("encoder_")] == [
            f"encoder_{i}" for i in range(4)]
    _assert_trees_equal(PSurg.convert_stream_layout(got), params)


def test_convert_stream_layout_walks_a_whole_train_state():
    params = _flax_params("sequential")
    state = {"params": params, "opt": [{"mu": params}, ({"nu": params}, 3)],
             "step": np.int32(5)}
    got = PSurg.convert_stream_layout(state)
    assert isinstance(got["opt"], list) and isinstance(got["opt"][1], tuple)
    assert got["opt"][1][1] == 3 and got["step"] == 5
    for sub in (got["params"], got["opt"][0]["mu"], got["opt"][1][0]["nu"]):
        assert sub["encoders"]["in_conv"]["bias"].shape == (4, 32)
    # leaves that do not share one leading dim in 2..8 are not a stream axis
    odd = {"encoders": {"a": np.zeros((4, 2)), "b": np.zeros((3, 2))}}
    assert set(PSurg.convert_stream_layout(odd)) == {"encoders"}
    assert PSurg._stacked_streams({"a": np.zeros((9, 2))}) is None
    assert PSurg._stacked_streams({}) is None


@pytest.mark.parametrize("use_edge", [False, True])
def test_converted_weights_load_into_the_other_layout(use_edge):
    """A sequential tree, converted, fills the vmap model and gives the
    sequential model's forward. Under ``use_edge`` the condition streams'
    stems are one channel wide in the sequential layout and two in the
    stacked one, so the trees do not convert (as in the JAX package)."""
    in_ch = 5 if use_edge else 4
    params = _flax_params("sequential", use_edge)
    kw = dict(device="cpu", in_channels=in_ch, out_channels=2,
              use_edge=use_edge, **TINY)
    seq = build_model("dsunet", **kw).eval()
    seq.load_state_dict(flax_to_state_dict(params, seq))
    stacked = build_model("dsunet", stream_mode="vmap", **kw).eval()
    if use_edge:
        with pytest.raises(ValueError, match="same shape|must have the same"):
            PSurg.convert_stream_layout(params)
        return
    stacked.load_state_dict(
        flax_to_state_dict(PSurg.convert_stream_layout(params), stacked))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 16, 16, in_ch)).astype(np.float32))
    t = torch.tensor([3.0, 742.0])
    with torch.no_grad():
        want, want_f = seq(x, t)
        got, got_f = stacked(x, t)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    for k in want_f:
        np.testing.assert_allclose(got_f[k].numpy(), want_f[k].numpy(),
                                   atol=1e-5, err_msg=k)
