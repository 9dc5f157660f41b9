"""The run's contract: the last line's keys, the compared numbers last, no
result without a card, and no result in a checkout without the port."""
import json
import shutil
import subprocess
import sys

import pytest

from portbench import harness

SMALL = {"config": {"scene": {"num_frames": 5}},
         "traffic": {"sequences": 1}}


@pytest.fixture(scope="module")
def result():
    return harness.rehearse("vio.seq", 2 ** 31 + 77, 0.2, **SMALL)


def test_result_keys(result, capsys):
    assert {"correct", "attempted", "failed", "metrics", "device"} \
        <= set(result)
    assert list(result)[-1] == "compared"
    assert result["correct"] is True
    assert set(result["metrics"]) == {"vio_frames_per_s", "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    harness.report(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["compared"] == result["compared"]
    tail = err.strip().splitlines()[-len(result["compared"]):]
    assert all(t.startswith("compared ") for t in tail)


def _cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "vio.seq",
         "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0",
         *extra], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    """Here, without a CUDA device, a measuring run fails and prints no
    result: it does not fall back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _cli(harness.ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.cuda
def test_without_the_port_no_result(tmp_path, card):
    """In a directory that holds only BENCHMARK.json and portbench/, a run
    fails before it prints a result."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout
