"""A later change adds a metric, a traffic mix or a cell with new files
under portbench/ and new BENCHMARK.json entries only: shown on a copy of
the benchmark with a dummy metric and a dummy traffic mix."""
import json
import os
import shutil
import subprocess
import sys

from portbench import harness

DUMMY = '''"""A dummy per-layer metric: the frames the window completed."""


def read(run):
    return float(run.frames) if run.frames else None
'''


def test_new_files_only(tmp_path):
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_bench()
    bench["end_to_end"].append(
        {"name": "dummy_frames", "unit": "frames", "better": "higher",
         "bound": 0.05, "source": "host_clock",
         "workloads": ["vio.fleet64.dummy"]})
    bench["workloads"].append(
        {"name": "vio.fleet64.dummy", "config": "visma_vio_corvis",
         "traffic": "fleet_dummy", "chips": 1, "why": "a dummy cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench" / "metrics" / "dummy_frames.py").write_text(DUMMY)
    traffic = json.loads((harness.PKG / "traffic" / "fleet64.json")
                         .read_text())
    traffic.update(batches=1, streams=2, frames_per_call=2,
                   streams_checked=1)
    (tmp_path / "portbench" / "traffic" / "fleet_dummy.json").write_text(
        json.dumps(traffic))
    code = ("import json\nfrom portbench import harness\n"
            "r = harness.rehearse('vio.fleet64.dummy', 5, 0.2, "
            "config={'scene': {'num_frames': 4}})\n"
            "assert harness.PKG.parent == __import__('pathlib').Path.cwd()\n"
            "print(json.dumps(r))\n")
    # the copy's portbench first (the working directory), the port behind
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert r["metrics"]["dummy_frames"]["value"] > 0
    assert "setup_s" in r["metrics"]
