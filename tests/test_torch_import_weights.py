"""``dsdiff_torch.cli.import_weights`` for each kind against the JAX
package's CLI functions (their Orbax save replaced by a recorder), on
random weight files in the published layouts: the same report (kind,
mapped, missing target leaves, unused source keys), and a ``params.pt``
that ``torch.load(weights_only=True)`` reads and that equals the JAX
params mapped onto the port's module, exactly. A file with a key removed
makes the run return 1, as the JAX CLI does. The kinds run through the
CLI's ``main`` in this process; one run goes through ``python -m`` for the
exit code."""
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dsdiff_tpu.cli import import_weights as JIW
from dsdiff_torch.cli import import_weights as PIW
from dsdiff_torch.eval.perceptual import ResNet50Features, VGG16Features
from dsdiff_torch.models.inception import InceptionV3
from dsdiff_torch.models.vae import AutoencoderKL
from dsdiff_torch.utils.flax_bridge import flax_to_state_dict
from dsdiff_torch.utils.inventories import fake_state_dict
from torch_eval_weights import (random_inception_state_dict,
                                random_resnet50_state_dict, write_safetensors,
                                write_vgg16_file)
from torch_parity_utils import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]
MODULES = {"sd_vae": lambda: AutoencoderKL(in_channels=3, out_channels=3),
           "vgg16": VGG16Features, "resnet50": ResNet50Features,
           "inception": InceptionV3}


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("weights")
    files = {"sd_vae": root / "vae-ft-mse.safetensors",
             "vgg16": root / "vgg16.pth", "lpips_lins": root / "vgg16.pth",
             "resnet50": root / "resnet50.pth",
             "inception": root / "pt_inception.pth"}
    write_safetensors(files["sd_vae"], {
        k: torch.from_numpy(v)
        for k, v in fake_state_dict("sd_vae_ft_mse").items()})
    write_vgg16_file(files["vgg16"])  # the trunk and the lpips heads
    torch.save({f"model.{k}": v for k, v in
                random_resnet50_state_dict(seed=1).items()},
               files["resnet50"])  # a RadImageNet-style prefix
    torch.save(random_inception_state_dict(seed=2), files["inception"])
    return files


def _jax_run(kind, path, tmp_path, monkeypatch, capsys):
    """The JAX CLI function for ``kind``: (rc, report, the tree it saves)."""
    saved = {}
    monkeypatch.setattr(JIW, "_save", lambda out, tree: saved.update(tree))
    capsys.readouterr()
    rc = JIW.KINDS[kind](str(path), str(tmp_path / "jax"))
    return rc, json.loads(capsys.readouterr().out), saved


def _port_run(kind, path, out_dir, capsys):
    """The port's CLI ``main``: (rc, report, what it prints after it)."""
    capsys.readouterr()
    rc = PIW.main(["--kind", kind, str(path), str(out_dir)])
    report, _, rest = capsys.readouterr().out.rpartition("}")
    return rc, json.loads(report + "}"), rest


@pytest.mark.parametrize("kind", sorted(PIW.KINDS))
def test_import_reports_and_saves_what_jax_does(kind, weight_files, tmp_path,
                                                monkeypatch, capsys):
    want_rc, want, tree = _jax_run(kind, weight_files[kind], tmp_path,
                                   monkeypatch, capsys)
    rc, got, rest = _port_run(kind, weight_files[kind], tmp_path / "pt",
                              capsys)
    assert rc == want_rc == 0
    assert got == want
    assert f"saved -> {tmp_path / 'pt' / 'params.pt'}" in rest
    state = torch.load(tmp_path / "pt" / "params.pt", weights_only=True)
    tree = jax.device_get(tree)
    if kind == "lpips_lins":
        assert set(state) == set(tree) == {f"lin{i}" for i in range(5)}
        for k, v in tree.items():
            np.testing.assert_array_equal(state[k].numpy(), np.asarray(v))
        return
    module = MODULES[kind]()
    want_state = flax_to_state_dict(tree, module)
    assert set(state) == set(want_state) == set(module.state_dict())
    for k, v in want_state.items():
        assert torch.equal(state[k], v), k


@pytest.mark.parametrize("kind, key", [
    ("vgg16", "features.0.weight"), ("lpips_lins", "lin3.model.1.weight"),
    ("resnet50", "model.layer2.0.bn1.running_var"),
    ("inception", "Mixed_6b.branch1x1.conv.weight")])
def test_a_removed_key_fails_the_import(kind, key, weight_files, tmp_path,
                                        monkeypatch, capsys):
    sd = torch.load(weight_files[kind], weights_only=True)
    del sd[key]
    path = tmp_path / "cut.pth"
    torch.save(sd, path)
    if kind in ("resnet50", "inception"):
        # both CLIs stop at the mapping: an uncaught error, exit code 1
        with pytest.raises((KeyError, ValueError)):
            _jax_run(kind, path, tmp_path, monkeypatch, capsys)
        with pytest.raises((KeyError, ValueError)):
            PIW.KINDS[kind](path, tmp_path / "pt")
        return
    want_rc, want, _ = _jax_run(kind, path, tmp_path, monkeypatch, capsys)
    rc, got, rest = _port_run(kind, path, tmp_path / "pt", capsys)
    assert rc == want_rc == 1 and got == want
    assert got["missing_target_leaves"] and "saved" not in rest
    assert not (tmp_path / "pt" / "params.pt").exists()


def test_a_removed_key_exits_1_through_python_m(weight_files, tmp_path):
    sd = torch.load(weight_files["resnet50"], weights_only=True)
    del sd["model.conv1.weight"]
    torch.save(sd, tmp_path / "cut.pth")
    out = subprocess.run(
        [sys.executable, "-m", "dsdiff_torch.cli.import_weights", "--kind",
         "resnet50", str(tmp_path / "cut.pth"), str(tmp_path / "pt")],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 1 and "KeyError" in out.stderr
