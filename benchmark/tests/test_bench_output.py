"""The result line of a run, driven on the CPU at a tiny size: its keys in
order, the cell's metrics with their units, and ``checks`` last."""
import json
import time

import pytest
import torch

from benchmark.harness import runner
from benchmark.run import result_line
from tiny import tiny_cell


@pytest.mark.parametrize("cell_name,trace", [("flagship-serve-b8", False),
                                             ("flagship-serve-b8", True),
                                             ("flagship-train-b32", False)])
def test_result_line(cell_name, trace):
    torch.manual_seed(0)
    cell = tiny_cell(cell_name)
    res = runner.run(cell, 3 * 2**30 + 7, 0.5, trace, "cpu",
                     time.perf_counter())
    line = json.loads(json.dumps(result_line(res, 1, trace, "cpu-test")))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(line) == keys + ["numbers", "checks"]
    assert isinstance(line["correct"], bool) and line["attempted"] > 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # the CPU run traces no device operation: every reader is silent
        assert line["metrics"] == {}
    else:
        wanted = {m["name"]: m["unit"] for m in cell.end_to_end}
        assert {k: v["unit"] for k, v in line["metrics"].items()} == wanted
        assert all(v["value"] > 0 for v in line["metrics"].values())
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
