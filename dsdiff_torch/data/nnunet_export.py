"""Export synthesized volumes into the nnU-Net raw-data layout.

Port of the JAX package's ``data/nnunet_export.py`` (a copy), its
re-design of preprocess/for_nnUNet.py: copy/rename per-case NIfTI volumes
into ``<out>/imagesTr/<task>_<case>_0000.nii.gz`` (+ labelsTr when masks are
given) with the dataset.json stub nnU-Net expects, feeding the downstream
segmentation-based Dice evaluation (inference/get_dice.py).
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

__all__ = ["export_nnunet_raw"]


def export_nnunet_raw(
    volumes: dict,
    out_dir,
    task_name: str = "Task500_synth",
    labels: dict | None = None,
    modality: str = "MRI",
):
    """volumes: {case: nii_path}; labels: optional {case: seg_nii_path}."""
    out = Path(out_dir) / task_name
    images = out / "imagesTr"
    images.mkdir(parents=True, exist_ok=True)
    if labels:
        labels_dir = out / "labelsTr"
        labels_dir.mkdir(parents=True, exist_ok=True)
    training = []
    for case, path in sorted(volumes.items()):
        dst = images / f"{task_name}_{case}_0000.nii.gz"
        shutil.copyfile(path, dst)
        entry = {"image": f"./imagesTr/{task_name}_{case}.nii.gz"}
        if labels and case in labels:
            ldst = out / "labelsTr" / f"{task_name}_{case}.nii.gz"
            shutil.copyfile(labels[case], ldst)
            entry["label"] = f"./labelsTr/{task_name}_{case}.nii.gz"
        training.append(entry)
    meta = {
        "name": task_name,
        "modality": {"0": modality},
        "labels": {"0": "background", "1": "foreground"},
        "numTraining": len(training),
        "training": training,
    }
    with open(out / "dataset.json", "w") as f:
        json.dump(meta, f, indent=2)
    return out
