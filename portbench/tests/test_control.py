"""The control, the plain reference a precision below the configuration's
float32 put in the program's place (TF32 products, the frontend in
bfloat16), comes out not correct: it fails at least one compared number.
On the card only (TF32 exists there), at a size a test run holds; the
cells' own size is read by `python3 -m portbench.calibrate`."""
import importlib

import pytest

from portbench import harness

SIZES = {"vio.seq": {"sequences": 1}, "vio.online": {"sequences": 1},
         "vio.fleet64": {"batches": 1, "streams": 8, "streams_checked": 2},
         "sem.settled": {}}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_control_fails(card, workload):
    bench = harness.load_bench()
    cell, config, traffic = harness.load_cell(bench, workload)
    if workload.startswith("vio."):
        config = harness._merge(config, {"scene": {"num_frames": 96}})
    traffic = harness._merge(traffic, SIZES[workload])
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    run = harness.Run(bench, cell, config, traffic, 2 ** 31 + 21, 3.0,
                      False, card)
    res = harness.execute(run, entry, 0.0)
    assert res["correct"] is True
    readings = entry.control(run)
    limits = {n: c["limit"] for n, c in res["compared"].items()}
    assert any(readings[n] > limits[n] for n in readings if n in limits)
