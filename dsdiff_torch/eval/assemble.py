"""Slice -> volume prediction assembly and offline metric reports.

Replaces the reference's predict-collection machinery
(trainer_use_gaussian_diff.py:602-655: collect {case: {slice: img}} on host,
read the template NIfTI, fill pred_array[slice], CopyInformation, write
``{task_id}_{case}_pred.nii.gz``) and the per-case metric drivers
(inference/get_metric.py:16-132 -> *_metric.xlsx; CSV here).

The port's own copy of the JAX package's ``eval/assemble.py``.
"""
from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from ..data.nifti import Nifti, read_nifti
from . import metrics

__all__ = ["VolumeAssembler", "write_metric_report", "evaluate_predictions"]


class VolumeAssembler:
    """Accumulates per-slice predictions and writes template-aligned NIfTIs."""

    def __init__(self, out_dir, task_id: str = "task"):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.task_id = task_id
        self._slices: dict[str, dict[int, np.ndarray]] = {}

    def add(self, case: str, slice_idx: int, img: np.ndarray):
        """img: [H, W] (crop any padding before adding)."""
        self._slices.setdefault(case, {})[int(slice_idx)] = np.asarray(img)

    def add_batch(self, cases, slice_idxs, imgs, valid=None):
        for i, (c, s) in enumerate(zip(cases, slice_idxs)):
            if valid is not None and not valid[i]:
                continue
            img = np.asarray(imgs[i])
            if img.ndim == 3:
                img = img[..., 0]
            self.add(c, s, img)

    def cases(self):
        return sorted(self._slices)

    def volume(self, case: str, template: Nifti | None = None) -> Nifti:
        slices = self._slices[case]
        if template is not None:
            vol = np.zeros(template.data.shape, dtype=np.float32)
            for idx, img in slices.items():
                h, w = vol.shape[0], vol.shape[1]
                # undo divisible_pad's symmetric padding: the front offsets
                # are ph//2 / pw//2 (data/transforms.py divisible_pad), so a
                # center-crop keeps the prediction aligned with the template
                ph, pw = img.shape[0] - h, img.shape[1] - w
                oh, ow = max(ph, 0) // 2, max(pw, 0) // 2
                vol[:, :, idx] = img[oh : oh + h, ow : ow + w]
            return Nifti.like(vol, template)
        n = max(slices) + 1
        h, w = next(iter(slices.values())).shape
        vol = np.zeros((h, w, n), dtype=np.float32)
        for idx, img in slices.items():
            vol[:, :, idx] = img
        return Nifti(vol)

    def write_case(self, case: str, template_path=None) -> Path:
        template = read_nifti(template_path) if template_path else None
        vol = self.volume(case, template)
        out = self.out_dir / f"{self.task_id}_{case}_pred.nii.gz"
        vol.save(out)
        return out


_XLSX_TYPES = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Types xmlns="http://schemas.openxmlformats.org/package/2006/'
    'content-types">'
    '<Default Extension="rels" ContentType="application/vnd.openxmlformats-'
    'package.relationships+xml"/>'
    '<Default Extension="xml" ContentType="application/xml"/>'
    '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.'
    'openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
    '<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/'
    'vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
    "</Types>"
)
_XLSX_RELS = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/'
    'relationships"><Relationship Id="rId1" Type="http://schemas.'
    'openxmlformats.org/officeDocument/2006/relationships/officeDocument" '
    'Target="xl/workbook.xml"/></Relationships>'
)
_XLSX_WORKBOOK = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/'
    'main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/'
    'relationships"><sheets><sheet name="metrics" sheetId="1" r:id="rId1"/>'
    "</sheets></workbook>"
)
_XLSX_WB_RELS = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/'
    'relationships"><Relationship Id="rId1" Type="http://schemas.'
    'openxmlformats.org/officeDocument/2006/relationships/worksheet" '
    'Target="worksheets/sheet1.xml"/></Relationships>'
)


def _xlsx_cell(value) -> str:
    if isinstance(value, (int, float, np.integer, np.floating)):
        v = float(value)
        if np.isfinite(v):
            return f"<c t=\"n\"><v>{v:.10g}</v></c>"
        value = str(v)  # nan/inf have no numeric cell form
    from xml.sax.saxutils import escape

    return f"<c t=\"inlineStr\"><is><t>{escape(str(value))}</t></is></c>"


def _write_xlsx(table: list[list], out_path: Path):
    """Minimal SpreadsheetML writer (stdlib zipfile only; inline strings,
    no shared-string table) — enough for Excel/pandas/openpyxl to open the
    reference's ``*_metric.xlsx`` report shape (inference/get_metric.py:
    120-132) without adding an openpyxl dependency."""
    import zipfile

    body = "".join(
        "<row>" + "".join(_xlsx_cell(c) for c in row) + "</row>"
        for row in table
    )
    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/'
        f'2006/main"><sheetData>{body}</sheetData></worksheet>'
    )
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _XLSX_TYPES)
        z.writestr("_rels/.rels", _XLSX_RELS)
        z.writestr("xl/workbook.xml", _XLSX_WORKBOOK)
        z.writestr("xl/_rels/workbook.xml.rels", _XLSX_WB_RELS)
        z.writestr("xl/worksheets/sheet1.xml", sheet)


def write_metric_report(rows: list[dict], out_path) -> Path:
    """Per-case rows + a mean row. ``.xlsx`` suffix writes a real Excel
    workbook (the reference's *_metric.xlsx format, get_metric.py:120-132);
    anything else writes CSV."""
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    if not rows:
        raise ValueError("no metric rows")
    keys = [k for k in rows[0] if k != "case"]
    mean_row = {"case": "mean"}
    for k in keys:
        mean_row[k] = float(np.mean([r[k] for r in rows]))
    if out_path.suffix.lower() == ".xlsx":
        table = [["case"] + keys] + [
            [r["case"]] + [r[k] for k in keys] for r in rows + [mean_row]
        ]
        _write_xlsx(table, out_path)
        return out_path
    with open(out_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["case"] + keys)
        w.writeheader()
        for r in rows + [mean_row]:
            w.writerow(r)
    return out_path


def evaluate_predictions(
    pred_dir,
    gt_root,
    gt_name: str = "S_Data2.nii.gz",
    report_path=None,
) -> list[dict]:
    """Per-case GT-vs-pred metric loop (inference/get_metric.py:16-132):
    predictions are ``*_pred.nii.gz`` under pred_dir; GT is
    ``<gt_root>/<case>/<gt_name>``."""
    pred_dir = Path(pred_dir)
    rows = []
    for pred_path in sorted(pred_dir.glob("*_pred.nii.gz")):
        case = pred_path.name[: -len("_pred.nii.gz")].split("_", 1)[-1]
        gt_path = Path(gt_root) / case / gt_name
        if not gt_path.exists():
            continue
        gt = read_nifti(gt_path).data
        pred = read_nifti(pred_path).data
        row = {"case": case}
        row.update(metrics.evaluate_volume(gt, pred))
        rows.append(row)
    if report_path is not None and rows:
        write_metric_report(rows, report_path)
    return rows
