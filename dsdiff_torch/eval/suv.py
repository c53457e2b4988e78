"""PET SUV quantification from predictions + DICOM radiopharmaceutical tags.

A copy of the JAX package's ``eval/suv.py`` (numpy only; the port imports
nothing of that package). Invert the training normalisation with the gold
volume's min/max, convert to activity with RescaleSlope/Intercept,
decay-correct the injected dose to scan time, SUV(bw) = activity *
weight_grams / decayed_dose; per-case statistics go to a CSV report.

A minimal DICOM tag reader for the handful of tags needed (explicit and
implicit VR little endian) is included, so no DICOM library is needed; a
plain-JSON parameter sidecar is the primary interface.
"""
from __future__ import annotations

import csv
import math
import struct
from pathlib import Path
from typing import Dict

import numpy as np

__all__ = [
    "read_dicom_tags",
    "inverse_normalize",
    "suv_from_prediction",
    "suv_report",
]

# (group, element) -> name for the tags the SUV math needs
# (SUV_calculate.py:22-33)
_TAGS = {
    (0x0010, 0x1030): "PatientWeight",
    (0x0008, 0x0031): "SeriesTime",
    (0x0028, 0x1053): "RescaleSlope",
    (0x0028, 0x1052): "RescaleIntercept",
    (0x0054, 0x0016): "RadiopharmaceuticalInformationSequence",
    (0x0018, 0x1072): "RadiopharmaceuticalStartTime",
    (0x0018, 0x1074): "RadionuclideTotalDose",
    (0x0018, 0x1075): "RadionuclideHalfLife",
}
_TEXT_VRS = {b"AE", b"AS", b"CS", b"DA", b"DS", b"DT", b"IS", b"LO", b"LT",
             b"PN", b"SH", b"ST", b"TM", b"UI", b"UT"}


def read_dicom_tags(path) -> Dict[str, str]:
    """Minimal DICOM reader for the SUV tag set (explicit VR little endian,
    descends into the radiopharmaceutical sequence)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[128:132] != b"DICM":
        raise ValueError(f"{path}: not a DICOM part-10 file")
    out: Dict[str, str] = {}
    pos = 132

    def parse(pos, end):
        while pos + 8 <= end:
            group, elem = struct.unpack_from("<HH", data, pos)
            vr = data[pos + 4 : pos + 6]
            if vr in (b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN"):
                length = struct.unpack_from("<I", data, pos + 8)[0]
                body = pos + 12
            elif vr.isalpha():
                length = struct.unpack_from("<H", data, pos + 6)[0]
                body = pos + 8
            else:  # implicit VR
                length = struct.unpack_from("<I", data, pos + 4)[0]
                vr = b"UN"
                body = pos + 8
            if length == 0xFFFFFFFF:
                # undefined-length sequence: parse items until delimiter
                p = body
                while p + 8 <= end:
                    g2, e2 = struct.unpack_from("<HH", data, p)
                    l2 = struct.unpack_from("<I", data, p + 4)[0]
                    if (g2, e2) == (0xFFFE, 0xE0DD):
                        p += 8
                        break
                    if (g2, e2) == (0xFFFE, 0xE000):
                        item_end = end if l2 == 0xFFFFFFFF else p + 8 + l2
                        parse(p + 8, item_end)
                        p = p + 8 + (0 if l2 == 0xFFFFFFFF else l2)
                    else:
                        p += 8 + l2
                pos = p
                continue
            name = _TAGS.get((group, elem))
            if name and vr != b"SQ":
                raw = data[body : body + length]
                if vr in _TEXT_VRS or vr == b"UN":
                    out[name] = raw.decode("ascii", "ignore").strip("\x00 ")
                elif vr == b"FD":
                    out[name] = str(struct.unpack("<d", raw[:8])[0])
                elif vr == b"FL":
                    out[name] = str(struct.unpack("<f", raw[:4])[0])
                elif vr in (b"US",):
                    out[name] = str(struct.unpack("<H", raw[:2])[0])
                elif vr in (b"UL",):
                    out[name] = str(struct.unpack("<I", raw[:4])[0])
            if vr == b"SQ":
                parse(body, body + length)
            pos = body + length
        return pos

    parse(pos, len(data))
    return out


def _time_to_seconds(t: str) -> float:
    """HHMMSS(.frac) -> seconds (SUV_calculate.py:52-59)."""
    t = t.strip()
    h, m = int(t[0:2]), int(t[2:4])
    s = float(t[4:]) if len(t) > 4 else 0.0
    return h * 3600 + m * 60 + s


def inverse_normalize(
    pred: np.ndarray, gold_min: float, gold_max: float, clip: bool = True
) -> np.ndarray:
    """[-1,1] prediction -> original intensity range using the gold volume's
    min/max (pred_suv_denorm_from_gold_minmax.py:105-131)."""
    p = np.asarray(pred, np.float64)
    if clip:
        p = np.clip(p, -1.0, 1.0)
    return (p + 1.0) / 2.0 * (gold_max - gold_min) + gold_min


def suv_from_prediction(pred_denorm: np.ndarray, params: Dict) -> np.ndarray:
    """Decay-corrected body-weight SUV (SUV_calculate.py:133-146).

    params: PatientWeight [kg], RadionuclideTotalDose [Bq],
    RadionuclideHalfLife [s], RadiopharmaceuticalStartTime, SeriesTime,
    RescaleSlope, RescaleIntercept.
    """
    p = {k: float(v) for k, v in params.items()
         if k in ("PatientWeight", "RadionuclideTotalDose",
                  "RadionuclideHalfLife", "RescaleSlope", "RescaleIntercept")}
    p.setdefault("RescaleSlope", 1.0)
    p.setdefault("RescaleIntercept", 0.0)
    dt = _time_to_seconds(str(params["SeriesTime"])) - _time_to_seconds(
        str(params["RadiopharmaceuticalStartTime"])
    )
    lam = math.log(2.0) / p["RadionuclideHalfLife"]
    dose_at_scan = p["RadionuclideTotalDose"] * math.exp(-lam * dt)
    activity = pred_denorm * p["RescaleSlope"] + p["RescaleIntercept"]
    return activity * (p["PatientWeight"] * 1000.0) / dose_at_scan


def suv_report(cases: dict, out_path) -> Path:
    """cases: {case: suv_volume}; writes per-case SUVmax/mean/p50 CSV
    (process_pred_dir, SUV_calculate.py:187-273)."""
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["case", "suv_max", "suv_mean", "suv_median", "suv_p99"])
        for case, vol in sorted(cases.items()):
            v = np.asarray(vol, np.float64)
            w.writerow([
                case, float(v.max()), float(v.mean()),
                float(np.median(v)), float(np.percentile(v, 99)),
            ])
    return out_path
