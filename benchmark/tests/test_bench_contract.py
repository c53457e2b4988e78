"""BENCHMARK.json against the benchmark's contract, and every cell
resolving to its files."""
import json
import re

import pytest

from benchmark.harness import spec

B = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in B["workloads"]]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "benchmark/run.py"]
    assert B["paths"] == ["benchmark"]
    assert all(PATH.match(p) for p in B["paths"])
    assert len(json.dumps(B)) <= 64 * 1024


def test_run_seconds_fits_a_check_of_24_cells():
    s = B["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entry_keys_and_names(section, keys):
    names = [e["name"] for e in B[section]]
    assert len(names) == len(set(names))
    for e in B[section]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e and section in ("configs", "workloads", "per_layer"):
                assert _line(e[k]), (e["name"], k)


def test_metrics():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in B["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert spec.metric_path(m["name"]).exists(), m["name"]
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], set()).add(m["name"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_and_reports(cell):
    c = spec.load_cell(cell)
    assert c.chips == 1
    assert c.traffic["kind"] in ("serve", "train")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
    assert c.limits["numbers"]


@pytest.mark.parametrize("entry", B["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    assert entry["file"].startswith("benchmark/")
    cfg = spec.load_json(spec.ROOT / entry["file"])
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    assert cfg["source"] == entry["source"] and _line(entry["source"])
    for key in cfg["reduced"]:
        assert NAME.match(key)
    for k in ("trainer", "model", "attention_calls", "forward_flops_per_sample",
              "assumed"):
        assert k in cfg


def test_each_config_used_and_pairs_unique():
    used = {w["config"] for w in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in B["workloads"]:
        assert spec.traffic_path(w["traffic"]).exists()
        assert spec.limits_path(w["name"]).exists()


def test_limits_record_their_readings():
    for cell in CELLS:
        for name, spec_ in spec.load_cell(cell).limits["numbers"].items():
            assert spec_["lower"] < spec_["limit"] < spec_["upper"], (cell, name)
