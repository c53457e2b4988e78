"""Published torch checkpoint -> the port module's state dict.

    python -m dsdiff_torch.cli.import_weights --kind sd_vae \
        vae-ft-mse-840000.ckpt out_dir/
    kinds: sd_vae | vgg16 | lpips_lins | resnet50 | inception

Port of the JAX package's ``cli/import_weights.py``: read the file
(safetensors or a zip pickle), key-map it onto the module, print the same
mapped / missing / unused report (JSON, in Flax paths), then save the
mapped state dict of the port's module as ``<out_dir>/params.pt``, which
``torch.load(path, weights_only=True)`` reads:
``AutoencoderKL(in_channels=3, out_channels=3)``, ``VGG16Features``,
``ResNet50Features``, ``InceptionV3``, or the five LPIPS head vectors
``lin0``..``lin4``. Runs on the host.

Exit code 1 if any target leaf stayed unmapped (an incomplete import).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


def _report(name, missing, unused, n_mapped):
    rep = {
        "kind": name,
        "mapped": n_mapped,
        "missing_target_leaves": sorted(missing),
        "unused_source_keys": sorted(unused),
    }
    print(json.dumps(rep, indent=2))
    return 1 if missing else 0


def _save(out_dir, state: dict):
    out_dir = Path(out_dir).absolute()
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.save(state, out_dir / "params.pt")
    print(f"saved -> {out_dir / 'params.pt'}")


def import_sd_vae(path, out_dir):
    from ..models.vae import AutoencoderKL
    from ..utils import torch_io

    vae = AutoencoderKL(in_channels=3, out_channels=3)
    mapped = torch_io.map_sd_vae(torch_io.load_checkpoint(path))
    state, missing, unused = torch_io.assign(vae, mapped)
    rc = _report("sd_vae", missing, unused, len(mapped) - len(unused))
    if rc == 0:
        _save(out_dir, state)
    return rc


def import_vgg16(path, out_dir):
    from ..eval.perceptual import _VGG16_LAYOUT, VGG16Features, map_vgg16
    from ..utils import torch_io

    sd = torch_io.load_checkpoint(path)
    mapped = map_vgg16(sd)
    state, missing, _ = torch_io.assign(VGG16Features(), mapped,
                                        make_fit=False)
    # classifier.* heads are not part of the LPIPS trunk
    consumed = {f"features.{i}.{s}" for _, idxs in _VGG16_LAYOUT
                for i in idxs for s in ("weight", "bias")}
    src_unused = sorted(k for k in sd if k not in consumed
                        and not k.startswith("classifier."))
    rc = _report("vgg16", missing, src_unused, len(mapped))
    if rc == 0:
        _save(out_dir, state)
    return rc


def import_lpips_lins(path, out_dir):
    from ..eval.perceptual import map_lpips_lins
    from ..utils import torch_io

    lins = map_lpips_lins(torch_io.load_checkpoint(path))
    missing = [f"lin{i}" for i, v in enumerate(lins) if v is None]
    rc = _report("lpips_lins", missing, [], sum(v is not None for v in lins))
    if rc == 0:
        _save(out_dir, {f"lin{i}": v for i, v in enumerate(lins)})
    return rc


def import_resnet50(path, out_dir):
    from ..eval.perceptual import ResNet50Features, map_resnet50
    from ..utils import torch_io
    from ..utils.flax_bridge import flax_leaves

    sd = torch_io.load_checkpoint(path)
    for pref in ("model.", "backbone.", "module."):
        if any(k.startswith(pref) for k in sd):
            sd = {k[len(pref):] if k.startswith(pref) else k: v
                  for k, v in sd.items()}
    net = ResNet50Features()
    mapped = flax_leaves(net, map_resnet50(sd))
    state, missing, unused = torch_io.assign(net, mapped, make_fit=False)
    rc = _report("resnet50", missing, unused, len(mapped))
    if rc == 0:
        _save(out_dir, state)
    return rc


def import_inception(path, out_dir):
    from ..models.inception import load_inception

    net = load_inception(path, device="cpu")
    state = {k: v for k, v in net.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    rc = _report("inception", [], [], sum(v.numel() for v in state.values()))
    _save(out_dir, net.state_dict())
    return rc


KINDS = {
    "sd_vae": import_sd_vae,
    "vgg16": import_vgg16,
    "lpips_lins": import_lpips_lins,
    "resnet50": import_resnet50,
    "inception": import_inception,
}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="dsdiff-torch-import-weights",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--kind", required=True, choices=sorted(KINDS))
    ap.add_argument("checkpoint", help="torch .ckpt/.pth/.safetensors file")
    ap.add_argument("out_dir", help="output directory (params.pt)")
    args = ap.parse_args(argv)
    return KINDS[args.kind](args.checkpoint, args.out_dir)


if __name__ == "__main__":
    sys.exit(main())
