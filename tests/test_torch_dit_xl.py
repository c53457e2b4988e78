"""DiT as the benchmark's ``dit-xl-8`` configuration trains it, on the CPU at
the reference's ``tiny`` size (2 blocks of 144, heads of 72, 32² images):

- the port's DiT forward in f32 against the plain reference
  (``benchmark/reference/denoisers/dit.py``) on the same seeded weights;
- ``remat``: ``model_params`` passes it for ``dit``, and a
  ``Trainer.train_step`` gives the same loss and gradients with the blocks
  checkpointed as without, recomputing each block inside the backward;
- the ``attention.backward`` span: one for each attention call of a
  backward while the tracer is on, with the call's sizes, and nothing
  recorded while it is off;
- the kernel's backward (``flash_attention.attention_vjp``) against
  autograd through the plain math it differentiates.
"""
import copy
import sys
from pathlib import Path

import pytest
import torch

from dsdiff_torch.models import dit as dit_mod
from dsdiff_torch.ops import flash_attention as fa
from dsdiff_torch.train.config import Config
from dsdiff_torch.train.trainer import Trainer, model_params
from dsdiff_torch.utils import profiling as P
from torch_parity_utils import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import spec, weights  # noqa: E402
from benchmark.reference import models  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_thread")

SEED = 2**31 + 22
CONFIG = spec.load_json(spec.BENCH / "configs" / "dit-xl-8.json")


@pytest.fixture(autouse=True)
def _tracer_off():
    P.disable()
    P.drain()
    yield
    P.disable()
    P.drain()


def _tiny(remat=True) -> dict:
    """The configuration's trainer block at the reference's tiny size, f32,
    batch 2."""
    tr = copy.deepcopy(models.denoiser("dit").tiny(CONFIG)["trainer"])
    tr.update(bf16=False, remat=remat, train_batch_size=2)
    return tr


def _inputs(B=2, size=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    batch = {"target": torch.rand(B, size, size, 1, generator=g) * 2 - 1,
             "image": torch.rand(B, size, size, 3, generator=g) * 2 - 1}
    t = torch.tensor([17, 803])
    noise = torch.randn(B, size, size, 1, generator=g)
    return batch, t, noise


def test_forward_matches_the_reference_in_f32():
    cfg = models.denoiser("dit").tiny(CONFIG)
    tr = Config(dict(cfg["trainer"], bf16=False))
    port = dit_mod.DiT(**model_params(tr, "dit", 3)).eval()
    ref = models.build(cfg).eval()
    assert sorted(n for n, _ in port.named_parameters()) == \
        sorted(n for n, _ in ref.named_parameters())
    weights.fill(port, SEED)
    weights.fill(ref, SEED)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 32, 32, 4, generator=g)
    t = torch.tensor([3.0, 917.0])
    with torch.no_grad():
        want, feats = ref(x, t)
        got = port(x, t)
    assert feats is None and got.shape == want.shape == (2, 32, 32, 2)
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


def test_model_params_passes_remat_for_dit():
    for on in (True, False):
        params = model_params(Config(_tiny(remat=on)), "dit", 3)
        assert params["remat"] is on
        assert dit_mod.DiT(**params).remat is on


def _one_step(remat: bool):
    trainer = Trainer(_tiny(remat), device="cpu")
    weights.fill(trainer.model, SEED)
    trainer.reset_state()
    batch, t, noise = _inputs()
    P.enable()
    metrics = trainer.train_step(batch, None, t=t, noise=noise)
    P.disable()
    spans = P.drain()["spans"]
    mu = trainer.state.state_dict()["mu"]
    return float(metrics["loss"]), {n: m.clone() for n, m in mu.items()}, spans


def test_remat_gives_the_same_loss_and_gradients():
    loss_on, mu_on, spans_on = _one_step(True)
    loss_off, mu_off, spans_off = _one_step(False)
    assert loss_on == pytest.approx(loss_off, rel=1e-6, abs=0)
    assert mu_on.keys() == mu_off.keys()
    for n in mu_on:
        scale = max(float(mu_off[n].abs().max()), 1e-12)
        assert float((mu_on[n] - mu_off[n]).abs().max()) <= 1e-5 * scale, n
    # each block once in the forward and once recomputed in the backward
    names = [r.name for r in spans_on]
    assert names.count("model.remat") == 2 * 2
    assert "model.remat" not in {r.name for r in spans_off}


def _attention_through_the_vjp(monkeypatch):
    """The DiT's attention through ``FlashAttention`` (whose backward is
    the one the card runs), its kernel launch played by the plain math."""
    monkeypatch.setattr(fa, "_launch", fa.reference_attention)
    monkeypatch.setattr(dit_mod, "scaled_attention", fa.FlashAttention.apply)


def test_attention_backward_span_once_per_call(monkeypatch):
    _attention_through_the_vjp(monkeypatch)
    tr = Config(_tiny(remat=False))
    model = dit_mod.DiT(**model_params(tr, "dit", 3)).train()
    weights.fill(model, SEED)
    x = torch.randn(2, 32, 32, 4, generator=torch.Generator().manual_seed(2))
    t = torch.tensor([5.0, 600.0])
    for on in (False, True):
        loss = model(x, t).square().mean()
        if on:
            P.enable()
        loss.backward()
        P.disable()
        spans = [r for r in P.drain()["spans"]
                 if r.name == "attention.backward"]
        if not on:
            assert spans == []
            continue
        assert len(spans) == model.depth
        assert all(r.attrs == {"B": 2, "N": 16, "heads": 2, "D": 72}
                   for r in spans)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N, M, H, D", [(16, 16, 2, 72), (24, 40, 3, 36)])
def test_attention_vjp_is_autograd_through_the_plain_math(dtype, N, M, H, D):
    """``attention_vjp`` (the kernel's backward) against autograd through
    ``reference_attention``: equal to f32 rounding, and each input's
    gradient alone where only it is wanted; strided q, k, v as a fused
    qkv projection gives them."""
    g = torch.Generator().manual_seed(N + M + D)
    q = torch.randn(2, N, 3, H, D, generator=g).to(dtype)[:, :, 0]
    k, v = torch.randn(2, M, 2, H, D, generator=g).to(dtype).unbind(2)
    dout = torch.randn(2, N, H, D, generator=g).to(dtype)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(fa.reference_attention(*leaves), leaves, dout)
    got = fa.attention_vjp(q, k, v, dout)
    ulp = 2e-6 if dtype == torch.float32 else 2**-7
    for w, x in zip(want, got):
        assert x.dtype == dtype and x.shape == w.shape
        err = (x.float() - w.float()).abs()
        assert float(err.max()) <= ulp * max(1.0, float(w.float().abs().max()))
    for i in range(3):
        needs = [j == i for j in range(3)]
        alone = fa.attention_vjp(q, k, v, dout, needs)
        assert all((a is None) != needs[j] for j, a in enumerate(alone))
        assert torch.equal(alone[i], got[i])
