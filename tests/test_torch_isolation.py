"""The port stands alone: it imports no JAX, Flax or dsdiff_tpu, none of
``transformers``, ``regex``, ``ftfy`` or ``safetensors`` (the card's
machine has none of them), and no package beyond torch, numpy and scipy at
import time (PyYAML, h5py, cv2, matplotlib, sklearn are imported inside the
functions that use them), and neither does chip_smoke.py."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dsdiff_torch
from dsdiff_torch.ops import quant

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "dsdiff_torch"

_IMPORT_ALL = """
import sys
BLOCKED = ("jax", "flax", "dsdiff_tpu", "yaml", "h5py", "cv2", "matplotlib",
           "sklearn", "transformers", "regex", "ftfy", "safetensors")
for name in BLOCKED:
    sys.modules[name] = None  # any import of them now raises ImportError
import importlib, pkgutil
import dsdiff_torch
names = [m.name for m in pkgutil.walk_packages(dsdiff_torch.__path__,
                                               "dsdiff_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = [m for m, mod in sys.modules.items()
          if mod is not None and m.split(".")[0] in BLOCKED]
assert not loaded, loaded
print(" ".join(names), len(names))
"""

# the serving slice's modules: each must be among those imported above
SERVING_MODULES = (
    "dsdiff_torch.core.sampling", "dsdiff_torch.core.dpm_solver",
    "dsdiff_torch.models.dsunet_cached", "dsdiff_torch.train.surgery",
    "dsdiff_torch.train.step", "dsdiff_torch.train.trainer",
)
# the data, fit and predict slice's modules
FIT_MODULES = (
    "dsdiff_torch.data.h5store", "dsdiff_torch.data.transforms",
    "dsdiff_torch.data.nifti", "dsdiff_torch.data.synthetic",
    "dsdiff_torch.data.curriculum", "dsdiff_torch.data.pipeline",
    "dsdiff_torch.data.npy_dataset", "dsdiff_torch.utils.logging",
    "dsdiff_torch.utils.misc", "dsdiff_torch.eval.metrics",
    "dsdiff_torch.eval.assemble", "dsdiff_torch.eval.visualize",
    "dsdiff_torch.train.checkpoints", "dsdiff_torch.cli.train",
    "dsdiff_torch.cli.sample",
)
# the latent pipeline's modules
LATENT_MODULES = (
    "dsdiff_torch.models.vae", "dsdiff_torch.models.discriminator",
    "dsdiff_torch.eval.perceptual", "dsdiff_torch.train.vae_trainer",
    "dsdiff_torch.train.vae_loop", "dsdiff_torch.train.latent",
    "dsdiff_torch.cli.train_vae",
)

# int8 serving, the device data cache and data-parallel training
RUN_MODE_MODULES = (
    "dsdiff_torch.ops.quant", "dsdiff_torch.data.device_cache",
    "dsdiff_torch.parallel.dist", "dsdiff_torch.parallel.mesh",
)

# the transformer conditioning path: attention modules, guidance, patching
TRANSFORMER_MODULES = (
    "dsdiff_torch.models.attention", "dsdiff_torch.models.encoders",
    "dsdiff_torch.models.encoder_unet", "dsdiff_torch.core.patching",
    "dsdiff_torch.core.composite_loss",
)

# the evaluation and measurement layer and the weight-file readers
EVAL_MODULES = (
    "dsdiff_torch.utils.torch_io", "dsdiff_torch.models.inception",
    "dsdiff_torch.eval.fid", "dsdiff_torch.eval.suv",
    "dsdiff_torch.utils.profiling", "dsdiff_torch.utils.benchtime",
    "dsdiff_torch.cli.evaluate",
)

# the last modules: published-layout weight import, preprocessing and the
# nnU-Net export, the CLIP towers
WEIGHTS_MODULES = (
    "dsdiff_torch.utils.inventories", "dsdiff_torch.cli.import_weights",
    "dsdiff_torch.data.preprocess", "dsdiff_torch.data.nnunet_export",
    "dsdiff_torch.cli.preprocess", "dsdiff_torch.models.clip",
)


def test_port_and_smoke_import_without_jax_flax_yaml_or_reference():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    n_modules = len(list(pkgutil.walk_packages(dsdiff_torch.__path__,
                                                "dsdiff_torch.")))
    *names, count = out.stdout.split()
    assert int(count) == n_modules >= 35
    assert (set(SERVING_MODULES) | set(FIT_MODULES) | set(LATENT_MODULES)
            | set(RUN_MODE_MODULES) | set(TRANSFORMER_MODULES)
            | set(EVAL_MODULES) | set(WEIGHTS_MODULES) <= set(names))


def test_no_port_file_mentions_the_reference_package_or_jax():
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu"))
    assert len(files) >= 20
    imports = re.compile(r"^\s*(import|from)\s+(jax|flax|dsdiff_tpu|"
                         r"transformers|regex|ftfy|safetensors)\b", re.M)
    for path in files:
        text = path.read_text()
        assert "dsdiff_tpu" not in text, path.relative_to(ROOT)
        assert "import jax" not in text, path.relative_to(ROOT)
        assert imports.search(text) is None, path.relative_to(ROOT)
    # chip_smoke names the replaced TPU kernel's file, but imports none of it
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert imports.search(smoke) is None
    assert "import jax" not in smoke and "import yaml" not in smoke


def test_the_port_has_every_module_of_the_jax_package():
    """The .py / .json file lists of the two packages differ only by the
    port's own modules: the kernels' build, device resolution, the Flax
    bridge and the CLIP towers (which the JAX package takes from
    ``transformers``)."""
    def files(pkg):
        return {p.relative_to(pkg).as_posix() for p in pkg.rglob("*")
                if p.suffix in (".py", ".json") and "_build" not in p.parts}

    jax_files, port_files = files(ROOT / "dsdiff_tpu"), files(PORT)
    assert not jax_files - port_files
    assert port_files - jax_files == {"ops/_build.py", "utils/device.py",
                                      "utils/flax_bridge.py", "models/clip.py"}


@pytest.mark.gpu
def test_int8_conv_sums_are_exact_on_the_card():
    """``torch._int_mm`` on the card (cuBLASLt's int8 GEMM) gives the exact
    int32 sums of an f64 conv of the same int8 operands, rows, K and N
    padded where it needs them; the dequantised output is the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(0)
    for B, C, O, hw, k, stride, groups in [
            (4, 96, 96, 32, 3, 1, 1), (2, 192, 288, 16, 3, 2, 1),
            (1, 36, 40, 3, 3, 1, 1), (2, 96, 192, 8, 1, 1, 1),
            (2, 32, 32, 16, 3, 1, 4)]:
        x = torch.randint(-127, 128, (B, C, hw, hw), generator=g,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (O, C // groups, k, k), generator=g,
                          dtype=torch.int8)
        got = quant.int8_sums(x.cuda(), quant.pack_weight(w.cuda(), groups),
                              (k, k), O, stride, k // 2, groups)
        want = torch.nn.functional.conv2d(x.double(), w.double(),
                                          stride=stride, padding=k // 2,
                                          groups=groups)
        assert torch.equal(got.cpu().double(), want.permute(0, 2, 3, 1)), (
            B, C, O, hw, k, stride, groups)
        xf = torch.randn(B, C, hw, hw, generator=g)
        scale = torch.rand(O, generator=g) * 1e-3 + 1e-4
        bias = torch.randn(O, generator=g)
        on_card = quant.int8_conv(xf.cuda(), w.cuda(), scale.cuda(),
                                  bias.cuda(), stride, k // 2, groups)
        on_cpu = quant.int8_conv(xf, w, scale, bias, stride, k // 2, groups)
        torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=1e-6,
                                   atol=1e-6 * float(on_cpu.abs().max()))
