"""The sequence runners through `utils.graphs.StepGraph` (the port's
counterpart of the reference's jit + scan) on the CPU, where the helper
runs its static-buffer copy-in / step / copy-out path without capture:
bit for bit the eager loops (`graph=False`), the same trajectory as the JAX
package's `VioPipeline.run`, the caller's start state untouched, no host
read in the whole pipeline step, and the launch-counter arithmetic of a
capture and its replays."""
import contextlib
import importlib
import pkgutil
import sys
from dataclasses import replace
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from visma_tpu.filter import FilterConfig as JConfig
from visma_tpu.io.synthetic import SyntheticConfig, make_imu
from visma_tpu.io.synthetic_images import render_blob_frames
from visma_tpu.pipeline import VioPipeline as JPipeline

from visma_tpu_torch import _kernels
from visma_tpu_torch.filter import FilterConfig, Msckf, stack_states
from visma_tpu_torch.filter.feed import pack_frames
from visma_tpu_torch.filter.update import _clone_placement
from visma_tpu_torch.io import synthetic as tsyn
from visma_tpu_torch.pipeline import VioPipeline
from visma_tpu_torch.utils import graphs
from visma_tpu_torch.utils.graphs import StepGraph

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_frame_step import _HostReads  # noqa: E402

FRAMES = 8          # 7 tracked frames


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """8 blob frames of 120x160 with IMU (the windowed tracker, 3 levels,
    window 6, 32 tracks)."""
    syn = SyntheticConfig(num_frames=FRAMES, num_landmarks=80, rows=120,
                          cols=160, fx=120.0, fy=120.0, cx=80.0, cy=60.0,
                          seed=13)
    frames, gwc, _ = render_blob_frames(syn)
    imu = make_imu(syn)
    spf = imu["samples_per_frame"]
    N = FRAMES - 1
    feed = dict(gyro=imu["gyro"][: N * spf].reshape(N, spf, 3),
                accel=imu["accel"][: N * spf].reshape(N, spf, 3),
                dts=np.full((N, spf), float(np.diff(imu["ts_state"])[0]),
                            np.float32))
    kw = dict(window=6, max_tracks=32, max_updates=8, fx=syn.fx, fy=syn.fy,
              cx=syn.cx, cy=syn.cy, pixel_noise=1.0)
    init = dict(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=imu["v0"])
    return dict(syn=syn, frames=frames, gwc=gwc, feed=feed, kw=kw, init=init)


def _pipe(scene, graph, num_slam=0):
    return VioPipeline(FilterConfig(**scene["kw"], num_slam=num_slam),
                       levels=3, cell=16, fused_klt=False, device="cpu",
                       graph=graph)


def _run(pipe, scene, st0=None):
    if st0 is None:
        st0 = pipe.init(scene["frames"][0], **scene["init"])
    return pipe.run(st0, scene["frames"][1:], **scene["feed"])


def _assert_trees_equal(a, b):
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    assert str(sa) == str(sb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.fixture(scope="module")
def vio(scene):
    """The scene through VioPipeline.run eagerly and through the helper,
    without and with SLAM landmarks."""
    out = {}
    for num_slam in (0, 4):
        for graph in (False, True):
            pipe = _pipe(scene, graph, num_slam)
            st0 = pipe.init(scene["frames"][0], **scene["init"])
            before = [t.clone() for t in pytree.tree_leaves(st0)]
            final, outs = _run(pipe, scene, st0)
            out[num_slam, graph] = dict(pipe=pipe, st0=st0, before=before,
                                        final=final, outs=outs)
    return out


@pytest.mark.parametrize("num_slam", [0, 4], ids=["vio", "slam4"])
def test_vio_helper_path_equals_eager(vio, num_slam):
    """(a) `VioPipeline(graph=True).run` on the CPU, the helper's copy-in /
    step / copy-out path, equals `graph=False` bit for bit: every output
    of every frame and the final state."""
    eager, helper = vio[num_slam, False], vio[num_slam, True]
    assert eager["pipe"].run_graph is None
    assert isinstance(helper["pipe"].run_graph, StepGraph)
    assert helper["pipe"].run_graph.captures == 0     # no capture on the CPU
    assert eager["outs"].keys() == helper["outs"].keys()
    _assert_trees_equal(eager["outs"], helper["outs"])
    _assert_trees_equal(eager["final"], helper["final"])
    assert int(helper["outs"]["obs_valid"].sum(axis=1).min()) >= 8
    if num_slam:
        assert int((helper["final"].filter.lm_ids >= 0).sum()) > 0


def test_vio_default_is_eager_on_the_cpu(scene):
    """`graph=None` loops eagerly on the CPU, as it replays a graph on a
    CUDA device."""
    assert _pipe(scene, None).run_graph is None
    assert Msckf(FilterConfig(), device="cpu").run_graph is None


def test_vio_helper_path_matches_jax(vio, scene):
    """(b) The same inputs through the JAX package's `VioPipeline.run`
    (jit + scan, the windowed tracker as here): the same track decisions
    in every frame and positions within 1.2e-7 m (the ingest slice's
    measured parity, tests/test_torch_ingest.py)."""
    jp = JPipeline(JConfig(**scene["kw"]), levels=3, cell=16,
                   fused_klt=False)
    js0 = jp.init(jnp.asarray(scene["frames"][0]), **scene["init"])
    _, jo = jp.run(js0, scene["frames"][1:], **scene["feed"])
    to = vio[0, True]["outs"]
    for key in ("obs_ids", "obs_valid", "feat_ids", "feat_status",
                "healthy"):
        np.testing.assert_array_equal(to[key].numpy(), np.asarray(jo[key]),
                                      err_msg=key)
    np.testing.assert_allclose(to["p"].numpy(), np.asarray(jo["p"]),
                               rtol=0, atol=1.2e-7)


def test_start_state_untouched_and_repeat_run_equal(vio, scene):
    """(d) The caller's start state is copied in, never aliased: unchanged
    after the run; a second run of the same instance from it (the cached
    buffers, copied in anew) equals the first, and so does a run from the
    first run's final state handed back in (a copy, not the buffers)."""
    helper = vio[4, True]
    for t, t0 in zip(pytree.tree_leaves(helper["st0"]), helper["before"]):
        np.testing.assert_array_equal(t.numpy(), t0.numpy())
    pipe = helper["pipe"]
    final, outs = _run(pipe, scene, helper["st0"])
    _assert_trees_equal(outs, helper["outs"])
    _assert_trees_equal(final, helper["final"])
    assert len(pipe.run_graph._entries) == 1
    # the final state is the caller's: the next run does not write it
    leaves = [t.clone() for t in pytree.tree_leaves(final)]
    _run(pipe, scene, final)
    for t, t0 in zip(pytree.tree_leaves(final), leaves):
        np.testing.assert_array_equal(t.numpy(), t0.numpy())


@pytest.mark.parametrize("fused", [False, True], ids=["windowed", "fused"])
def test_step_full_reads_nothing_back(scene, fused):
    """(e) The whole `VioPipeline.step_full`, the tracker (pyramid, LK,
    detection, replenishment; the windowed tracker, and the fused one's
    plain twin) and the filter with SLAM landmarks, on CPU tensors under a
    TorchDispatchMode: no `aten._local_scalar_dense` (a host read, which a
    capture refuses) and no `aten.lift_fresh` (a constant made on the
    host, a pageable copy on the card) once the first frame has made the
    step's cached constants."""
    pipe = VioPipeline(FilterConfig(**scene["kw"], num_slam=4), levels=3,
                       cell=16, fused_klt=fused, device="cpu", graph=False)
    st = pipe.init(scene["frames"][0], **scene["init"])
    feed = {k: torch.as_tensor(v) for k, v in scene["feed"].items()}
    images = torch.as_tensor(scene["frames"][1:])

    def step(st, i):
        return pipe.step_full(st, images[i], feed["gyro"][i],
                              feed["accel"][i], feed["dts"][i])[0]

    st = step(st, 0)
    mode = _HostReads()
    with mode:
        for i in range(1, FRAMES - 1):
            st = step(st, i)
    assert mode.reads == 0
    assert mode.fresh == 0
    assert bool(torch.isfinite(st.filter.p).all())


@pytest.fixture(scope="module")
def feeds():
    """Three feature feeds of 12 frames (seeds 0-2) with IMU, packed."""
    syn = tsyn.SyntheticConfig(num_frames=12, num_landmarks=120,
                               pixel_noise=0.5, seed=0)
    cfg = FilterConfig(window=6, max_tracks=48, max_updates=12, fx=syn.fx,
                       fy=syn.fy, cx=syn.cx, cy=syn.cy)
    imu = tsyn.make_imu(syn)
    _, gwc = tsyn.make_trajectory(syn)
    packs = [pack_frames(cfg, tsyn.make_dataset(replace(syn, seed=s)), imu,
                         max_feats=48) for s in range(3)]
    frames = {k: torch.as_tensor(np.stack([pk[k] for pk in packs]))
              for k in packs[0] if k != "ts"}
    init = dict(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=imu["v0"])
    return cfg, frames, init


def test_msckf_run_helper_equals_eager(feeds):
    """(c) `Msckf.run` through the helper equals its eager loop bit for
    bit, over a run shorter than the warm-up + 1 and a longer one."""
    cfg, frames, init = feeds
    eager = Msckf(cfg, device="cpu", graph=False)
    helper = Msckf(cfg, device="cpu", graph=True)
    s0 = eager.init(**init)
    one = {k: v[0] for k, v in frames.items()}
    for n in (2, 12):
        part = {k: v[:n] for k, v in one.items()}
        fe, oe = eager.run(s0, part)
        fh, oh = helper.run(s0, part)
        _assert_trees_equal(oe, oh)
        _assert_trees_equal(fe, fh)


def test_run_batched_helper_equals_eager(feeds):
    """(c) `Msckf.run_batched` (vmap of the frame step over 3 streams)
    through the helper equals its eager loop bit for bit, (B, N) outputs
    and final states."""
    cfg, frames, init = feeds
    eager = Msckf(cfg, device="cpu", graph=False)
    helper = Msckf(cfg, device="cpu", graph=True)
    states = stack_states([eager.init(**init)] * 3)
    fe, oe = eager.run_batched(states, frames)
    fh, oh = helper.run_batched(states, frames)
    assert oh["p"].shape == (3, 12, 3) and oh["p"].is_contiguous()
    _assert_trees_equal(oe, oh)
    _assert_trees_equal(fe, fh)


def test_cached_constants_are_never_evicted():
    """A replayed graph reads the step's cached constants by address, with
    no Python to refresh them: every cache in the port keeps its entries
    for the life of the process (an evicted constant's memory would be
    handed to other tensors under a live graph)."""
    import visma_tpu_torch

    caches = {}
    for mod in pkgutil.walk_packages(visma_tpu_torch.__path__,
                                     "visma_tpu_torch."):
        m = importlib.import_module(mod.name)
        for name, fn in vars(m).items():
            if callable(fn) and hasattr(fn, "cache_info") \
                    and getattr(fn, "__module__", None) == mod.name:
                caches[f"{mod.name}.{name}"] = fn.cache_info().maxsize
    for name in ("filter.update._clone_placement", "utils.misc._footprint",
                 "filter.imu._gravity_vector"):
        assert f"visma_tpu_torch.{name}" in caches
    assert {k: v for k, v in caches.items() if v is not None} == {}


def test_repeat_run_after_other_configurations(feeds):
    """Nine other filter configurations run between two runs of one
    `Msckf(graph=True)`: the first run's cached constants are still the
    same tensors, and the second run equals the first bit for bit."""
    cfg, frames, init = feeds
    kf = Msckf(cfg, device="cpu", graph=True)
    s0 = kf.init(**init)
    one = {k: v[0] for k, v in frames.items()}
    first = kf.run(s0, one)
    M, D = cfg.window, s0.P.shape[-1]
    placement = _clone_placement(M, D, s0.P.device)
    for w in (3, 4, 5, 7, 8, 9, 10, 11, 12):
        other = Msckf(replace(cfg, window=w), device="cpu", graph=False)
        other.run(other.init(**init), {k: v[:3] for k, v in one.items()})
    assert _clone_placement(M, D, s0.P.device) is placement
    _assert_trees_equal(kf.run(s0, one), first)
    assert len(kf.run_graph._entries) == 1


class _StubStream:
    device = torch.device("cpu")

    def wait_stream(self, other):
        pass


class _StubGraph:
    """Stands in for torch.cuda.CUDAGraph: the step runs once while it is
    "captured" (its launches counted, as the Python of a real capture
    counts them), a replay runs nothing."""

    def capture_begin(self, capture_error_mode="global"):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


@pytest.fixture
def stub_cuda(monkeypatch):
    """The CUDA branches of StepGraph and CallGraph on stand-in streams
    and graphs."""
    monkeypatch.setattr(graphs._Captures, "_side_stream",
                        staticmethod(lambda device: _StubStream()))
    monkeypatch.setattr(graphs.torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(graphs.torch.cuda, "current_stream",
                        lambda device=None: _StubStream())
    monkeypatch.setattr(graphs.torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())


def test_capture_failure_raises(stub_cuda):
    """A step that fails while it is captured raises GraphCaptureError
    naming its line, with nothing run eagerly in its place: the frame's
    launches taken back out, no graph kept, the next run warms up anew."""
    def kernel():
        kernel.launches += 1

    _kernels.counted(kernel)
    calls = []
    try:
        def body(state, x):
            calls.append(1)
            kernel()
            if len(calls) == 3:
                raise RuntimeError("operation not permitted when stream is "
                                   "capturing")
            return state + x, {"s": state + x}

        sg = StepGraph(body)
        with pytest.raises(graphs.GraphCaptureError,
                           match="test_torch_graphs.py:[0-9]+ .*raise "
                                 "RuntimeError"):
            sg.run(torch.zeros(()), torch.ones(5))
        assert (sg.captures, kernel.launches, len(calls)) == (0, 2, 3)
        assert not sg._entries
    finally:
        _kernels._COUNTED.remove(kernel)


def test_launch_counter_arithmetic(stub_cuda):
    """(f) A capture counts 0 and each replay the launches its capture
    recorded. A stub step "launches" a counted wrapper twice a frame, and
    the CUDA branches run on stand-in streams and graphs: 7 frames count 2
    warm-ups x 2 + the capture's 2 taken back out + 5 replays x 2 = 14, one
    capture; a second run of the same shapes replays all 7 frames (14, no
    capture); a wrapper the step does not call counts 0."""
    def stub_kernel():
        stub_kernel.launches += 1

    def idle_kernel():
        idle_kernel.launches += 1

    _kernels.counted(stub_kernel)
    _kernels.counted(idle_kernel)
    try:
        def body(state, x):
            stub_kernel()
            stub_kernel()
            return state + x, {"s": state + x}

        sg = StepGraph(body)
        sg.run(torch.zeros(()), torch.ones(7))
        assert (sg.captures, stub_kernel.launches) == (1, 14)
        stub_kernel.launches = 0
        sg.run(torch.zeros(()), torch.ones(7))
        assert (sg.captures, stub_kernel.launches) == (1, 14)
        assert idle_kernel.launches == 0
    finally:
        _kernels._COUNTED.remove(stub_kernel)
        _kernels._COUNTED.remove(idle_kernel)


def test_mesh_collectives_counted_through_replays(stub_cuda, monkeypatch):
    """A mesh's collectives as its runner's counts: a stub PCG step that
    all_reduces cg_iters + 3 = 7 times a step on the group-less one-rank
    mesh. The capture counts 0 and each replay 7: 7 steps count 2 warm-ups
    x 7 + the capture's 7 taken back out + 5 replays x 7 = 49, one
    capture; a repeat run of the same shapes counts all 7 steps through
    replays (49, no capture). The same through a CallGraph: an eager
    call, a capture with its replay, a replay: 3 x 7."""
    from visma_tpu_torch.dist.mesh import make_mesh
    from visma_tpu_torch.utils.graphs import CallGraph

    mesh = make_mesh(device="cpu")
    per_step = 4 + 3

    def step(state, x):
        for _ in range(per_step):
            state = mesh.all_reduce(state)
        return state + x, state

    sg = StepGraph(step, counts=(mesh.counts,))
    sg.run(torch.zeros(()), torch.ones(7))
    assert (sg.captures, mesh.counts["all_reduce"]) == (1, 49)
    mesh.counts.update(all_reduce=0)
    sg.run(torch.zeros(()), torch.ones(7))
    assert (sg.captures, mesh.counts["all_reduce"]) == (1, 49)

    mesh.reset_counts()
    cg = CallGraph(lambda x: step(x, x)[0], counts=(mesh.counts,))
    for _ in range(3):
        cg(torch.ones(()))
    assert (cg.captures, mesh.counts) == (1, {
        "all_reduce": 3 * per_step, "all_gather": 0,
        "all_reduce_floats": 3 * per_step, "all_gather_floats": 0})
