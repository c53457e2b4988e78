"""The port stands alone: it imports no JAX, Flax or dsdiff_tpu, and no
package beyond torch, numpy and scipy at import time (PyYAML, h5py, cv2,
matplotlib, sklearn are imported inside the functions that use them), and
neither does chip_smoke.py."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import dsdiff_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "dsdiff_torch"

_IMPORT_ALL = """
import sys
BLOCKED = ("jax", "flax", "dsdiff_tpu", "yaml", "h5py", "cv2", "matplotlib",
           "sklearn")
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
            <= set(names))


def test_no_port_file_mentions_the_reference_package_or_jax():
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu"))
    assert len(files) >= 20
    imports = re.compile(r"^\s*(import|from)\s+(jax|flax|dsdiff_tpu)\b", re.M)
    for path in files:
        text = path.read_text()
        assert "dsdiff_tpu" not in text, path.relative_to(ROOT)
        assert "import jax" not in text, path.relative_to(ROOT)
        assert imports.search(text) is None, path.relative_to(ROOT)
    # chip_smoke names the replaced TPU kernel's file, but imports none of it
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert imports.search(smoke) is None
    assert "import jax" not in smoke and "import yaml" not in smoke
