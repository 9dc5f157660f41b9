"""The twins of the repo's scripts (visma_tpu_torch/tools/*,
visma_tpu_torch/bench_scaling.py) against the reference's scripts
(tools/*.py, bench_scaling.py) on the CPU, at tiny sizes, one torch
thread.

Each reference script is loaded from its file beside its twin and both get
the same seeded inputs:
  * the analytic payload (`comm_floats_per_step`) and the link model
    (`allreduce_time`) are equal, number for number;
  * `_displacement_stats` is equal on the same scene, and `run_point`'s
    ATE at 96x128 over 12 frames agrees to 1e-5 m (the pipeline parity
    tests' position tolerance; both through the fused LK tracker, the
    reference's in Pallas interpret mode), its other numbers exactly;
  * spawn_sweep's scenes (mesh names, placements, yaws) are the
    reference's for seeds 100-101;
  * a 4-rank gloo GN step's measured payload is the analytic one for
    dense; for PCG it is the analytic one plus 30 K floats: the reference's
    count takes the (K, 6, 6) block-Jacobi preconditioner it all_reduces
    for a 6K diagonal;
  * profile_filter's full-step variant, replayed through its StepGraph's
    buffers, equals the eager `_frame_step` bit for bit, and a variant's
    time is the median of its rounds.
Every twin's entry point wants the card unless given --device cpu, and
none writes by default into the repository outside build/."""
import importlib.util
import os
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
TWINS = ("profile_filter", "profile_stages", "profile_cem", "diag_semantic",
         "noise_sweep", "spawn_sweep", "scaling_model")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: one torch thread beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_script(path: str):
    """The reference's script at `path` (relative to the repo) as a
    module; what it sets in the environment on import is undone."""
    name = "reference_" + Path(path).stem
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ), mock.patch.object(sys, "path",
                                                        list(sys.path)):
        spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("solver", ["dense", "pcg", "submap"])
def test_comm_floats_per_step_is_the_reference(solver):
    from visma_tpu_torch.bench_scaling import comm_floats_per_step

    ref = reference_script("bench_scaling.py").comm_floats_per_step
    for n in (1, 2, 4, 8):
        for poses in (16, 64):
            for kw in ({}, dict(cg_iters=40, landmarks_per_device=2048,
                                halo=1)):
                assert comm_floats_per_step(solver, poses, n, **kw) \
                    == ref(solver, poses, n, **kw)


def test_allreduce_time_is_the_reference():
    from visma_tpu_torch.tools.scaling_model import allreduce_time

    ref = reference_script("tools/scaling_model.py")
    for payload in (0, 384, 37248, 4 * 9312):
        for n in (1, 2, 4, 64):
            for rounds in (1, 27):
                assert allreduce_time(payload, n, ref.ICI_ALPHA,
                                      ref.ICI_W_BYTES, rounds=rounds) \
                    == ref.allreduce_time(payload, n, rounds=rounds)
    # the link is an assumption the caller states: no default
    with pytest.raises(TypeError):
        allreduce_time(384, 2)


def _sweep_scene(cls):
    f = 240.0 * 128 / 320.0
    return cls(num_frames=12, num_landmarks=240, rows=96, cols=128, seed=7,
               angular_rate=0.35, fx=f, fy=f, cx=63.5, cy=47.5)


def test_displacement_stats_is_the_reference():
    from visma_tpu.io.synthetic import (SyntheticConfig, make_landmarks,
                                        make_trajectory)
    from visma_tpu_torch.tools.noise_sweep import _displacement_stats

    ref = reference_script("tools/noise_sweep.py")
    syn = _sweep_scene(SyntheticConfig)
    _, gwc = make_trajectory(syn)
    X = make_landmarks(syn)
    assert _displacement_stats(syn, gwc, X) \
        == ref._displacement_stats(syn, gwc, X)


def test_run_point_matches_the_reference(monkeypatch):
    """One grid point (noise 4, two occluders) at 96x128 over 12 frames."""
    import visma_tpu.frontend.klt_fused as JKF
    import visma_tpu.frontend.tracker as JTR
    import visma_tpu.pipeline as JP
    from visma_tpu.filter import FilterConfig as JConfig
    from visma_tpu.io.synthetic import SyntheticConfig as JSyn
    from visma_tpu_torch.filter import FilterConfig
    from visma_tpu_torch.io.synthetic import SyntheticConfig
    from visma_tpu_torch.tools.noise_sweep import run_point

    fused = JKF.track_features_fused
    monkeypatch.setattr(JTR, "track_features_fused",
                        lambda *a, **k: fused(*a, interpret=True, **k))

    class FusedPipeline(JP.VioPipeline):
        def __init__(self, *a, **k):
            super().__init__(*a, fused_klt=True, **k)

    monkeypatch.setattr(JP, "VioPipeline", FusedPipeline)
    ref = reference_script("tools/noise_sweep.py")

    def cfg(cls, s):
        return cls(window=8, max_tracks=96, max_updates=24, fx=s.fx,
                   fy=s.fy, cx=s.cx, cy=s.cy, pixel_noise=1.0)

    js, ts = _sweep_scene(JSyn), _sweep_scene(SyntheticConfig)
    want = ref.run_point(js, cfg(JConfig, js), 4.0, 2)
    got = run_point(ts, cfg(FilterConfig, ts), 4.0, 2, device="cpu")
    assert abs(got[0] - want[0]) < 1e-5, (got, want)
    assert got[1:] == want[1:]
    assert got[3] and got[0] < 0.01


class _Captured(Exception):
    pass


class _StubRenderer:
    def __init__(self, seen):
        self.seen = seen

    def index(self, name):
        self.seen.setdefault("names", []).append(name)
        return 0

    def render_depth(self, poses, mesh_idx):
        self.seen["poses"] = np.asarray(poses)
        raise _Captured


@pytest.mark.parametrize("seed", [100, 101])
def test_spawn_scene_is_the_reference(seed, monkeypatch):
    """The reference's run_scene up to its first render (a stub mapper
    records the mesh names and the frame-0 poses, the ground truth since
    frame 0's camera is the identity) against the twin's `scene`."""
    from scipy.spatial.transform import Rotation

    import visma_tpu.semantic as JS
    from visma_tpu_torch.tools.spawn_sweep import scene

    seen = {}

    class StubMapper:
        def __init__(self, *a, **k):
            self.mrenderer = _StubRenderer(seen)

    monkeypatch.setattr(JS, "SemanticMapper", StubMapper)
    ref = reference_script("tools/spawn_sweep.py")
    with pytest.raises(_Captured):
        ref.run_scene(seed, n_frames=2)
    names, T_gt, yaws = scene(seed)
    assert names == seen["names"]
    np.testing.assert_array_equal(T_gt[:, :3, :4].astype(np.float32),
                                  seen["poses"][0])
    ref_yaw = Rotation.from_matrix(seen["poses"][0, :, :3, :3]
                                   .astype(np.float64)).as_euler("yxz")[:, 0]
    np.testing.assert_allclose(yaws, ref_yaw, atol=1e-6)


def test_measured_payload_of_a_gloo_gn_step():
    """Four gloo ranks (spawned, on the CPU): one GN step's all-reduced
    floats as the mesh counts them, less the step's cost scalar."""
    from visma_tpu_torch.bench_scaling import comm_floats_per_step, gloo_sweep

    poses, lpd = 8, 32
    sweep = gloo_sweep([4], torch.device("cpu"), solvers=["dense", "pcg"],
                       poses=poses, landmarks_per_device=lpd, reps=1,
                       cg_iters=5, submap_iters=2, timeout_s=180)
    for solver in ("dense", "pcg"):
        (pt,) = sweep["solvers"][solver]["points"]
        m = pt["measured_floats"]
        analytic = comm_floats_per_step(solver, poses, 4, 5, lpd)
        assert pt["comm_floats_per_step"] == analytic
        extra = 0 if solver == "dense" else 30 * poses
        assert m["all_reduce"] == analytic + extra, (solver, m, analytic)
        assert m["all_gather"] == 0
        assert m["collectives"]["all_reduce"] \
            == (3 if solver == "dense" else 5 + 3)
        assert pt["mesh"] == "gloo" and pt["devices"] == 4


def test_profile_filter_full_variant_is_the_frame_step():
    """n = 4 replays of the full-step variant through its StepGraph's
    buffers (graph=True on the CPU) against four eager `_frame_step`s."""
    from visma_tpu_torch.filter.msckf import _frame_step
    from visma_tpu_torch.tools import profile_filter as pf
    from visma_tpu_torch.utils.misc import tree_leaves

    cfg = pf.bench_config()
    s0, frame = pf.warm_state(cfg, torch.device("cpu"))
    (name, v_full), = [v for v in pf.variants(cfg) if v[0].startswith("full")]
    run, graph = pf.variant_run(v_full, s0, frame, 4)
    final, sums = run()
    want = s0
    for _ in range(4):
        want = _frame_step(cfg, want, frame)
    for a, b in zip(tree_leaves(final), tree_leaves(want)):
        assert torch.equal(a, b)
    assert float(sums[-1]) == float(want.P.sum())
    res = pf.profile(cfg, torch.device("cpu"), n=2, reps=3,
                     log=lambda s: None)
    assert [r["variant"] for r in res["variants"]] \
        == [n for n, _ in pf.variants(cfg)]
    for r in res["variants"]:             # a round a run of a new graph
        assert len(r["rounds_ms"]) == 3
        assert r["ms_per_step"] == sorted(r["rounds_ms"])[1]
    assert res["stages_sum_ms"] == res["variants"][-2]["ms_per_step"]


def test_profile_cem_categorize_takes_whole_setups():
    """profile_cem's split of a dispatch's device events: each K4 with the
    setup launched before it (a graph's copy kernel and an eager copy
    named alike), the edge score's kernels, the rest; a K4 whose setup
    lost its first kernel (the profiler drops a session's first records)
    raises instead of being split short."""
    from visma_tpu_torch.tools.profile_cem import RASTER, categorize

    k4 = (f"void {RASTER}<4>(...)", 2.0)
    setups = [["gather", "gemm", "memcpy32_post", "sort"],
              ["gather", "gemm_b", "sort"]]
    seq = [("draw", 1.0), ("gather", 1.0), ("gemm", 1.0),
           ("Memcpy DtoD (Device -> Device)", 1.0), ("sort", 1.0), k4,
           ("edt", 1.0), ("gather", 1.0), ("gemm_b", 1.0), ("sort", 1.0), k4,
           ("edge_score_tiles", 1.0), ("edge_score_finish", 1.0)]
    assert categorize(seq, setups) == (
        ["other"] + ["prep"] * 4 + ["raster", "other"] + ["prep"] * 3
        + ["raster", "score", "score"])
    with pytest.raises(RuntimeError, match="none of the setup"):
        categorize(seq[2:], setups)


def test_twins_want_the_card_and_write_under_build():
    """Without --device each twin raises where there is no card; the
    sweeps' default output is under build/."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import importlib

    from visma_tpu_torch import bench_scaling
    from visma_tpu_torch.tools.common import output_path

    mains = [importlib.import_module(f"visma_tpu_torch.tools.{t}").main
             for t in TWINS]
    args = {"scaling_model": ["--link-latency-s", "1e-6",
                              "--link-bandwidth-bytes", "1e9"]}
    for t, main in zip(TWINS, mains):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(args.get(t, []))
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_scaling.main([])
    for name in ("noise_sweep.md", "spawn_sweep.md"):
        assert output_path("", name).parent == ROOT / "build" / "tools"


def test_dryrun_prints_the_weak_scaling_sweep():
    """dryrun.py's weak-scaling dump on the one-rank mesh: a point a
    solver, its measured payload beside the analytic one, a line each."""
    from visma_tpu_torch import dryrun
    from visma_tpu_torch.dist import make_mesh

    lines = []
    sweep = dryrun.weak_scaling(make_mesh(device="cpu"), reps=1,
                                log=lines.append)
    assert sorted(sweep["solvers"]) == ["dense", "pcg", "submap"]
    (dense,) = sweep["solvers"]["dense"]["points"]
    assert dense["mesh"] == "group-less" and dense["devices"] == 1
    assert dense["measured_floats"]["all_reduce"] \
        == dense["comm_floats_per_step"]
    assert len(lines) == 4 and all("measured floats" in ln
                                   for ln in lines[1:])
