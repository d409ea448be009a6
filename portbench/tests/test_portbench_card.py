"""On the card, at each cell's own size: a short run is correct and its
control (the lower-precision path in the program's place) is not.  Skipped
where there is no card; on the GPU machine:
python3 -m pytest portbench/tests -q -m card"""

from __future__ import annotations

import json

import pytest

from portbench import harness

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_cell_is_correct_and_its_control_is_not(card, workload):
    res = harness.run(workload, 2**31 + 1234, 2.0, False, control=True)
    assert res["device"]["platform"] == "gpu"
    assert res["correct"], res["check"]
    limits = {n: c["limit"] for n, c in res["check"].items()}
    assert any(res["control"][n] > limits[n] for n in limits), res["control"]
