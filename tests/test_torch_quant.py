"""Int8 serving (``dsdiff_torch.ops.quant`` and ``Trainer.set_sampler(int8=
...)``) against the JAX package's ``ops/quant.py``, f32 on the CPU.

- ``quantize_weight`` / ``quantize_activation``: the int8 values bit for
  bit, the scales within 1 ulp.
- ``int8_conv`` at ``tests/test_quant.py``'s (strides, padding, groups)
  cases: the int32 sums equal XLA's exactly; the outputs within 1e-6 of the
  largest output (a bias that cancels the sum leaves no relative scale).
- the convs that run in int8 are the JAX interceptor's, by module path.
- ``calibrate_act_scales`` on the same forwards: 1e-6 relative.
- a forward of the ``TINY`` DSUNet, and a DDIM-3 request through the
  ``Trainer`` (dynamic, static, and the cached ``ds_diff_split`` sampler),
  given JAX's x_T and calibration noise, with each int8 conv given the
  activation JAX quantised at the same call (JAX run eagerly, its convs
  recorded in call order, the port's convs checked to be called in the same
  order with the same module names). Without that, the two paths part at
  the first activation whose f32 value lies within rounding noise of a
  quantisation tie (their f32 convolutions sum in another order): one int8
  step there moves every later activation's rounding, and the two int8
  outputs end as far apart as either is from f32. Each conv's output within
  1e-6 of its largest; the final output within ``FORWARD_ATOL`` /
  ``CHAIN_ATOL`` absolute, each checked in the test to be at most a tenth
  of the same output's int8-vs-f32 gap, so that a path that skipped
  quantisation fails.
- ``set_sampler(int8=False)`` restores the compute-dtype request bit for
  bit; the int8 weights follow the EMA and are quantised once per change.
"""
import contextlib
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from dsdiff_tpu.core import sampling as JS
from dsdiff_tpu.core import schedules as JSch
from dsdiff_tpu.data import synthetic as JSyn
from dsdiff_tpu.models.dsunet import DSUNet as JDSUNet
from dsdiff_tpu.ops import quant as JQ
from dsdiff_tpu.parallel import mesh as pmesh
from dsdiff_tpu.train import Config as JConfig
from dsdiff_tpu.train import Trainer as JTrainer
from dsdiff_tpu.train import state as JState
from dsdiff_tpu.train import step as JStep
from dsdiff_torch.models import build_model
from dsdiff_torch.ops import quant as Q
from dsdiff_torch.train.trainer import Trainer
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict
from torch_parity_utils import (TINY, nchw_to_nhwc, nhwc_to_nchw, one_thread,
                                random_flax_params, tiny_cfg)

pytestmark = pytest.mark.usefixtures("one_thread")

OUT_TOL = 1e-6  # int8_conv outputs, of the largest output
SCALE_RTOL = 1e-6  # calibrated activation scales
FORWARD_ATOL = 1e-4  # one int8 forward, output of order 1
CHAIN_ATOL = 1e-4  # a DDIM-3 int8 request, clipped to [-1, 1]
GAP_SHARE = 0.1  # each tolerance at most this share of the int8-f32 gap
KEYS = ["A", "B", "C", "GT"]


@pytest.fixture(scope="module")
def jax_model():
    """The ``TINY`` Flax DSUNet and seeded weights, built once (its eager
    init takes seconds)."""
    jm = JDSUNet(in_channels=4, out_channels=2, **TINY)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)),
                     jnp.zeros((1,)))["params"]
    return jm, random_flax_params(params, 5)


def _port_model(params):
    model = build_model("dsunet", in_channels=4, out_channels=2, device="cpu",
                        **TINY)
    model.load_state_dict(flax_to_state_dict(params, model))
    return model.eval()


def _inputs(seed=11, B=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 16, 16, 4)).astype(np.float32)
    t = np.array([37.0, 811.0], np.float32)[:B]
    return x, t


@pytest.mark.parametrize("shape", [(3, 3, 32, 48), (1, 1, 96, 32)])
def test_quantize_weight_matches_jax(shape):
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    w_i8, scale = JQ.quantize_weight(jnp.asarray(w))
    got_i8, got_scale = Q.quantize_weight(
        torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))))
    assert got_i8.dtype == torch.int8
    np.testing.assert_array_equal(got_i8.numpy().transpose(2, 3, 1, 0),
                                  np.asarray(w_i8))
    np.testing.assert_array_max_ulp(got_scale.numpy(), np.asarray(scale), 1)


@pytest.mark.parametrize("static", [None, 0.0123])
def test_quantize_activation_matches_jax(static):
    x = 3.0 * np.random.default_rng(2).standard_normal((2, 8, 8, 16)).astype(
        np.float32)
    x_i8, scale = JQ.quantize_activation(jnp.asarray(x), scale=static)
    got_i8, got_scale = Q.quantize_activation(torch.from_numpy(x), static)
    np.testing.assert_array_equal(got_i8.numpy(), np.asarray(x_i8))
    np.testing.assert_array_max_ulp(np.float32(got_scale),
                                    np.float32(scale), 1)
    if static:
        assert np.abs(got_i8.numpy()).max() == 127  # saturated


@pytest.mark.parametrize(
    "strides,padding,groups",
    [((1, 1), 1, 1), ((2, 2), 1, 1), ((1, 1), "SAME", 1),
     ((1, 1), "VALID", 1), ((1, 1), 1, 4)],
)
def test_int8_conv_matches_jax(strides, padding, groups):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16, 32)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, 32 // groups, 32))).astype(np.float32)
    b = (0.01 * rng.standard_normal(32)).astype(np.float32)
    want = np.asarray(JQ.int8_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), strides=strides,
        padding=padding, feature_group_count=groups))
    x_i8, _ = JQ.quantize_activation(jnp.asarray(x))
    w_i8, _ = JQ.quantize_weight(jnp.asarray(w))
    dn = lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    want_sums = np.asarray(lax.conv_general_dilated(
        x_i8, w_i8, strides, JQ._norm_padding(padding, 2),
        dimension_numbers=dn, feature_group_count=groups,
        preferred_element_type=jnp.int32))

    tw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    tx = nhwc_to_nchw(x)
    p_i8, _ = Q.quantize_activation(tx)
    pw_i8, pw_scale = Q.quantize_weight(tw)
    sums = Q.int8_sums(p_i8, Q.pack_weight(pw_i8, groups), (3, 3), 32,
                       strides, padding, groups)
    assert sums.dtype == torch.int32
    np.testing.assert_array_equal(sums.numpy(), want_sums)
    before = Q.LAUNCHES
    got = Q.int8_conv(tx, pw_i8, pw_scale, torch.from_numpy(b), strides,
                      padding, groups)
    assert Q.LAUNCHES == before + 1
    got = nchw_to_nhwc(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=OUT_TOL * np.abs(want).max())


def test_int8_sums_pad_rows_and_k_exactly():
    """Fewer than 17 rows and a K that is no multiple of 8 (a 3x3 conv over
    36 channels): padded with zeros, the sums stay exact."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(-127, 128, (1, 36, 3, 3), np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (40, 36, 3, 3), np.int8))
    sums = Q.int8_sums(x, Q.pack_weight(w), (3, 3), 40, 1, 1)
    want = torch.nn.functional.conv2d(x.double(), w.double(), padding=1)
    assert Q.pack_weight(w).shape == (1, 40, 328)
    assert torch.equal(sums.double(), want.permute(0, 2, 3, 1))


def _record_jax(fn):
    """Run ``fn()`` eagerly with every int8 conv call recorded, in order:
    [(module path, input, output)] as numpy, NHWC."""
    calls = []

    def spy(next_fn, args, kwargs, context):
        mod = context.module
        out = next_fn(*args, **kwargs)
        if (isinstance(mod, fnn.Conv) and context.method_name == "__call__"
                and JQ._eligible(mod, args[0], 32)):
            calls.append((JQ._conv_key(mod).replace("/", "."),
                          np.asarray(args[0]), np.asarray(out)))
        return out

    with jax.disable_jit(), fnn.intercept_methods(spy):
        result = fn()
    return calls, result


@contextlib.contextmanager
def _teacher(model, calls):
    """Give each int8 conv of ``model`` the input JAX's conv had at the same
    call, checking that the calls come in JAX's order; each conv's output
    is held against JAX's."""
    names = {m: n for n, m in model.named_modules()}
    pending = list(calls)

    def pre(mod, args):
        name, x, _ = pending[0]
        assert names[mod] == name, (names[mod], name)
        return (torch.from_numpy(np.array(x)).permute(0, 3, 1, 2),)

    def post(mod, args, out):
        _, _, want = pending.pop(0)
        np.testing.assert_allclose(
            out.permute(0, 2, 3, 1).numpy(), want, rtol=0,
            atol=OUT_TOL * np.abs(want).max(), err_msg=names[mod])

    hooks = []
    for m in model.modules():
        if getattr(m, "int8", None) is not None or (
                hasattr(m, "int8") and any(names[m] == c[0] for c in calls)):
            hooks += [m.register_forward_pre_hook(pre),
                      m.register_forward_hook(post)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
    assert not pending, f"{len(pending)} JAX int8 calls the port did not make"


def _jax_swapped(jm, params, x, t):
    """Paths of the convs JAX's interceptor runs in int8, in call order
    (recorded while the forward is traced)."""
    seen = []

    def spy(next_fn, args, kwargs, context):
        mod = context.module
        if (isinstance(mod, fnn.Conv) and context.method_name == "__call__"
                and JQ._eligible(mod, args[0], 32)):
            seen.append(JQ._conv_key(mod).replace("/", "."))
        return next_fn(*args, **kwargs)

    def forward(x, t):
        with fnn.intercept_methods(spy):
            return jm.apply({"params": params}, x, t)

    jax.eval_shape(forward, jnp.asarray(x), jnp.asarray(t))
    return seen


def test_swapped_convs_are_the_jax_interceptors(jax_model):
    jm, params = jax_model
    x, t = _inputs()
    want = _jax_swapped(jm, params, x, t)
    model = _port_model(params)
    n = Q.quantize_model(model, model.state_dict())
    got = Q.quantized_convs(model)
    assert n == len(got) == len(set(want)) == len(want) > 10
    assert set(got) == set(want)
    before = Q.LAUNCHES
    with torch.no_grad():
        model(torch.from_numpy(x), torch.from_numpy(t))
    assert Q.LAUNCHES - before == len(want)  # each once per forward
    Q.dequantize_model(model)
    assert Q.quantized_convs(model) == []


def _jax_scales(jm, params, inputs):
    return JQ.calibrate_act_scales(
        jm.apply, [({"params": params}, jnp.asarray(x), jnp.asarray(t))
                   for x, t in inputs])


def test_calibrate_act_scales_matches_jax(jax_model):
    jm, params = jax_model
    inputs = [_inputs(11), _inputs(12)]
    want = _jax_scales(jm, params, inputs)
    model = _port_model(params)
    got = Q.calibrate_act_scales(
        model, [(torch.from_numpy(x), torch.from_numpy(t)) for x, t in inputs])
    assert set(got) == {k.replace("/", ".") for k in want}
    for key, v in want.items():
        np.testing.assert_allclose(got[key.replace("/", ".")], v,
                                   rtol=SCALE_RTOL, err_msg=key)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_int8_forward_matches_jax(jax_model, mode):
    jm, params = jax_model
    x, t = _inputs(13)
    scales = (_jax_scales(jm, params, [_inputs(11), _inputs(12)])
              if mode == "static" else None)

    def forward():
        return np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                                   jnp.asarray(t))[0])

    def int8_forward():
        with JQ.int8_convs(act_scales=scales):
            return forward()

    calls, want = _record_jax(int8_forward)  # the spy outside the int8 one
    model = _port_model(params)
    with torch.no_grad():  # f32, within 1e-5 of JAX's (test_torch_dsunet)
        plain = model(torch.from_numpy(x), torch.from_numpy(t))[0].numpy()
    Q.quantize_model(model, model.state_dict(), act_scales=None if scales
                     is None else {k.replace("/", "."): v
                                   for k, v in scales.items()})
    with torch.no_grad(), _teacher(model, calls):
        got = model(torch.from_numpy(x), torch.from_numpy(t))[0].numpy()
    gap = np.abs(want - plain).max()
    assert FORWARD_ATOL <= GAP_SHARE * gap, gap
    np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_ATOL)


# ------------------------------------------------------------ trainer level
@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("quant")
    JSyn.make_structured_dataset(root / "data", n_cases=5, n_slices=2, hw=16,
                                 seed=0)
    return root


def _cfg(store):
    cfg = tiny_cfg(3)
    cfg.update(h5_2d_img_dir=str(store / "data"), image_size=16,
               train_keys=KEYS, train_batch_size=2, val_batch_size=2,
               fold_K=2, fold_idx=0, log_images=False,
               # the JAX package's static calibration leaks a tracer out of
               # a remat (checkpointed) block; the port serves without remat
               remat=False)
    return cfg


@pytest.fixture(scope="module")
def trainers(store, tmp_path_factory):
    """The JAX and the port's trainers on one store and one set of
    weights."""
    cfg = _cfg(store)
    tmp = tmp_path_factory.mktemp("quant_runs")
    jt = JTrainer(JConfig.wrap(cfg), tmp / "jax", mesh=pmesh.local_mesh())
    params = random_flax_params(jt.state.params["params"], 5)
    jt.state = JState.TrainState.create(jt.model.apply, {"params": params},
                                        jt.state.tx, ema_decay=0.9999)
    pt = Trainer(cfg, tmp / "port", device="cpu")
    pt.load_flax_params({"params": params})
    yield jt, pt
    jt.ckpt.close()


@pytest.fixture(scope="module")
def jax_scales(trainers):
    """JAX's static calibration on the trainers' weights, by port name."""
    jt, _ = trainers
    return {k.replace("/", "."): v
            for k, v in jt._calibrate_int8_scales().items()}


def _calibration_noise(jt):
    """The noise ``_calibrate_int8_scales`` draws from PRNGKey(17)."""
    rng = jax.random.PRNGKey(17)
    out = []
    for i, batch in enumerate(jt.val_loader.epoch(0)):
        if i >= 2:
            break
        for _ in range(5):
            rng, k = jax.random.split(rng)
            out.append(torch.from_numpy(np.array(
                jax.random.normal(k, batch["target"].shape))))
    return out


def test_trainer_static_calibration_matches_jax(trainers, jax_scales):
    jt, pt = trainers
    got = pt._calibrate_int8_scales(noise=_calibration_noise(jt))
    assert set(got) == set(jax_scales)
    for key, v in jax_scales.items():
        np.testing.assert_allclose(got[key], v, rtol=SCALE_RTOL, err_msg=key)


def _x_T(rng, cond):
    x_rng, _ = jax.random.split(rng)
    return torch.from_numpy(np.array(jax.random.normal(
        x_rng, cond.shape[:3] + (1,), jnp.float32)))


@pytest.mark.parametrize("mode", [True, "static"])
def test_trainer_int8_request_matches_jax(trainers, jax_scales, mode,
                                         monkeypatch):
    jt, pt = trainers
    cond = next(iter(jt.val_loader.epoch(0)))["image"]
    rng = jax.random.PRNGKey(4)
    x_T = _x_T(rng, cond)
    plain = pt.sample_fn(torch.from_numpy(cond), x_T=x_T).numpy()
    jt.set_sampler(int8=mode)
    calls, want = _record_jax(lambda: np.asarray(jt.sample_fn(
        jt.state.ema_params, jnp.asarray(cond), rng)))
    # the port's calibration is held above; the request takes JAX's scales,
    # which the frameworks' f32 forwards reach within an ulp or two, and an
    # ulp moves the rounding of an activation at a tie
    scales = jax_scales if mode == "static" else None
    monkeypatch.setattr(pt, "_calibrate_int8_scales", lambda: scales)
    pt.set_sampler(int8=mode)
    before = Q.LAUNCHES
    with _teacher(pt.sample_model, calls):
        got = pt.sample_fn(torch.from_numpy(cond), x_T=x_T).numpy()
    per_forward = len(Q.quantized_convs(pt.sample_model))
    pt.set_sampler(int8=False)
    assert Q.LAUNCHES - before == 3 * per_forward > 0
    gap = np.abs(want - plain).max()
    assert CHAIN_ATOL <= GAP_SHARE * gap, gap
    np.testing.assert_allclose(got, want, rtol=0, atol=CHAIN_ATOL)


def test_cached_sampler_int8_matches_jax():
    """``ds_diff_split`` serves int8 through its cached-condition sampler,
    dynamic scales, as the JAX trainer's ``_make_cached_sample_fn`` with
    ``sample_int8``."""
    from dsdiff_tpu.models.dsunet_cached import DSUNetSplit as JSplit

    jm = JSplit(in_channels=4, out_channels=2, dtype=jnp.float32, **TINY)
    params = random_flax_params(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)),
        jnp.zeros((1,)))["params"], 9)
    cfg = tiny_cfg(3)
    cfg.update(net_mode="ds_diff_split")
    trainer = Trainer(cfg, device="cpu")
    trainer.load_flax_params(params)
    rsched = JSch.respace(JSch.make_beta_schedule("scaled_linear", 1000),
                          JSch.space_timesteps(1000, "3"))
    stand_in = types.SimpleNamespace(
        model=jm, sampler_name="ddim", eta=0.0, cfg={"clip_denoised": True},
        base_out=1, task=JStep.TaskConfig(parameterization="v",
                                          learn_sigma=True,
                                          variance_type="fixed_large"))
    cond = np.random.default_rng(15).standard_normal(
        (2, 16, 16, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(8)
    plain = trainer.sample_fn(torch.from_numpy(cond),
                              x_T=_x_T(rng, cond)).numpy()
    stand_in.sample_int8 = True
    fn = JTrainer._make_cached_sample_fn(stand_in, rsched)
    calls, want = _record_jax(lambda: np.asarray(fn(
        {"params": params}, jnp.asarray(cond), rng)))
    trainer.set_sampler(int8="static")  # the cached sampler stays dynamic
    assert trainer._act_scales is None
    before = Q.LAUNCHES
    trainer.sample_fn(torch.from_numpy(cond[:, :2, :2]))  # quantise first
    with _teacher(trainer.sample_model, calls):
        got = trainer.sample_fn(torch.from_numpy(cond), x_T=_x_T(rng, cond))
    assert Q.LAUNCHES > before
    gap = np.abs(want - plain).max()
    assert CHAIN_ATOL <= GAP_SHARE * gap, gap
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CHAIN_ATOL)


def test_set_sampler_int8_round_trip_and_refresh(trainers, monkeypatch):
    _, pt = trainers
    cond = torch.from_numpy(_inputs(16)[0][..., :3])
    x_T = torch.from_numpy(_inputs(17)[0][..., :1])
    calls = []
    quantize = Q.quantize_model

    def counting(*args, **kw):
        calls.append(1)
        return quantize(*args, **kw)

    monkeypatch.setattr(Q, "quantize_model", counting)
    first = pt.sample_fn(cond, x_T=x_T)
    pt.set_sampler(int8=True)
    a = pt.sample_fn(cond, x_T=x_T)
    b = pt.sample_fn(cond, x_T=x_T)
    assert len(calls) == 1  # once per weights, not per request
    assert torch.equal(a, b) and not torch.equal(a, first)
    pt.set_sampler(int8=False)
    assert Q.quantized_convs(pt.sample_model) == []
    assert torch.equal(pt.sample_fn(cond, x_T=x_T), first)  # bit for bit
    # a train step moves the EMA: the next int8 request quantises it anew
    pt.set_sampler(int8=True)
    pt.train_step({"image": cond, "target": x_T.clamp(-1, 1)},
                  torch.Generator().manual_seed(0))
    c = pt.sample_fn(cond, x_T=x_T)
    assert len(calls) == 2 and not torch.equal(c, a)
    ema = pt.state.ema_state_dict()
    name = Q.quantized_convs(pt.sample_model)[0]
    conv = dict(pt.sample_model.named_modules())[name]
    (w_i8, _, _, bias), = conv.int8.sets.values()
    assert torch.equal(w_i8, Q.quantize_weight(ema[f"{name}.weight"])[0])
    assert torch.equal(bias, ema[f"{name}.bias"])
    pt.set_sampler(int8=False)
    with pytest.raises(ValueError):
        pt.set_sampler(int8="dynamic")


@pytest.fixture(scope="module")
def cli_run(store, tmp_path_factory):
    """A run config and a run trained one step by ``cli.train``."""
    import yaml

    from dsdiff_torch.cli import train as train_cli

    tmp = tmp_path_factory.mktemp("quant_cli")
    cfg = _cfg(store)
    cfg.update(result_path=str(tmp / "results"), Task_name="synth",
               limit_val_batches=1)
    path = tmp / "run.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert train_cli.main(["--config_file", str(path), "--max_steps", "1",
                           "--device", "cpu"]) == 1
    return path, tmp / "results" / "synth_r1_ds_diff_gaussian_fold2-0"


@pytest.mark.parametrize("mode", [[], ["--int8"], ["--int8", "static"]])
def test_cli_sample_serves_int8(cli_run, tmp_path, mode, monkeypatch):
    """``python -m dsdiff_torch.cli.sample --int8 [static]`` restores a
    checkpoint and predicts the test split with int8 convolutions."""
    from dsdiff_torch.cli import sample as sample_cli

    path, workdir = cli_run
    modes = []
    set_sampler = Trainer.set_sampler

    def spy(self, *args, **kw):
        modes.append(kw.get("int8"))
        return set_sampler(self, *args, **kw)

    monkeypatch.setattr(Trainer, "set_sampler", spy)
    before = Q.LAUNCHES
    out_dir, _ = sample_cli.main(["--config_file", str(path), "--workdir",
                                  str(workdir), "--out_dir",
                                  str(tmp_path / "pred"), "--device", "cpu"]
                                 + mode)
    assert len(list(out_dir.glob("*_pred.nii.gz"))) == 1
    want = {0: [], 1: [True], 2: ["static"]}[len(mode)]
    assert modes == want
    assert (Q.LAUNCHES > before) == bool(mode)
