"""The kernels' work counts give the bounds of PERF.md's kernel table at
its shapes (chip_smoke.py's arithmetic at 43be5d3), and the roofline
modules are the one list of the port's hand-written kernels, matched by
exact name."""
import types

import pytest

from portbench import readers, roofline
from portbench.entries import vio_common
from portbench.harness import load_bench, load_cell
from portbench.roofline import (bound_s, k1_corner_cells, k2_lk_track,
                                k4_chunk_raster_batched, k5_edge_score,
                                k6_bilinear_remap)
from portbench.trace_read import Window

SHAPES = {"rows": 500, "cols": 960, "cell": 32, "levels": 4,
          "max_tracks": 96, "lk_window": 24, "lk_radius": 5, "lk_iters": 8}
# PERF.md's K4 / K5 shape: 4 objects x 24 windows of 256x384, 41 chunks
SEM = {"roi": (256, 384), "sub_px": 16, "chunk": 128, "chunks": 41,
       "objects": 4, "samples": 24, "k4_pairs_per_window": 0.0}


@pytest.mark.parametrize("mod, ms", [(k1_corner_cells, 0.00115),
                                     (k2_lk_track, 0.000661)],
                         ids=["k1_corner_cells", "k2_lk_track"])
def test_bound_ms(mod, ms):
    t, by = bound_s(*mod.work(SHAPES))
    assert by == "bytes"
    assert abs(t * 1e3 - ms) / ms < 0.005


def test_edge_score_bound_ms():
    t, by = bound_s(*k5_edge_score.work(SEM, 1))
    assert by == "bytes"
    assert abs(t * 1e3 - 0.0127) / 0.0127 < 0.005


def test_k4_hypotheses_launch_bytes():
    """The hypotheses' launch of 96 windows: 68.1 MB, 0.0203 ms."""
    n_bytes, _ = k4_chunk_raster_batched.launch(SEM, 96)
    assert abs(n_bytes / 1e6 - 68.1) < 0.1
    t, _ = bound_s(n_bytes, 0.0)
    assert abs(t * 1e3 - 0.0203) / 0.0203 < 0.005


def test_k6_bound_ms():
    """The path's call: 240 u8 frames 600x960 -> 500x960 through the
    crop's rows of the Corvis table, 0.0688 ms."""
    _, config, _ = load_cell(load_bench(), "vio.seq")
    shapes = dict(SHAPES, remap_frames=240,
                  remap_source_pixels=vio_common.remap_source_pixels(config))
    assert shapes["remap_source_pixels"] == 463_840
    t, by = bound_s(*k6_bilinear_remap.work(shapes))
    assert by == "bytes"
    assert abs(t * 1e3 - 0.0688) / 0.0688 < 0.005


K3 = ("void (anonymous namespace)::chunk_raster_kernel<32>(float const*, "
      "int const*, int const*, float*, int, int, int, int, int, float, "
      "float)")
K4 = K3.replace("<32>", "<16>")
TILES = ("void (anonymous namespace)::edge_score_tiles<true, true>(float "
         "const*, float const*, int)")
REMAP = ("void (anonymous namespace)::bilinear_remap_kernel<unsigned char, "
         "1, true>(unsigned char const*, float const*, unsigned char*)")
ADD = ("void at::native::vectorized_elementwise_kernel<4, "
       "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, "
       "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)")


def test_kernel_names():
    assert roofline.kernel_names(K4) == ("chunk_raster_kernel<16>",
                                         "chunk_raster_kernel")
    assert roofline.kernel_names("corner_score_kernel(float const*)") == (
        "corner_score_kernel", "corner_score_kernel")
    assert roofline.kernel_names(ADD)[1] == "vectorized_elementwise_kernel"


def test_exact_names_tell_k3_from_k4():
    names = k4_chunk_raster_batched.DEVICE_NAMES
    assert roofline.matches(K4, names) and not roofline.matches(K3, names)
    assert not roofline.matches("chunk_raster_kernel_v2<16>(int)", names)


def test_hand_kernels_are_the_roofline_modules():
    mods = roofline.kernels()
    assert set(mods) >= {"k1_corner_cells", "k2_lk_track",
                         "k4_chunk_raster_batched", "k5_edge_score",
                         "k6_bilinear_remap"}
    for op in (K4, TILES, REMAP, "corner_score_kernel(float const*)",
               "lk_track_kernel(LkLevels)"):
        assert roofline.hand_kernel(op), op
    assert not roofline.hand_kernel(ADD)
    assert not roofline.hand_kernel(K3)     # K3 has no module: no cell runs it


def _run(ops, mark_end):
    w = Window(ops=ops, host_launches=len(ops), graph_launches=0, replays=0,
               replay_ops=0, spans=[], window_s=1.0, plain_s=0.5,
               mark_end=mark_end)
    return types.SimpleNamespace(window=w, trace_frames=2, shapes={},
                                 notes={}, power_limit_w=None)


def test_idle_share_from_the_trace_alone():
    """Busy 65 us of a span of 100 us from the marker's end (the host's
    clocks, 1 s traced and 0.5 s untraced, play no part): 35% idle."""
    run = _run([("a", 110.0, 140.0), ("b", 130.0, 150.0),
                (ADD, 170.0, 190.0), (K4, 195.0, 200.0)], mark_end=100.0)
    assert readers.idle_share(run) == pytest.approx(35.0)
    # the op chains: every operation but the hand kernel, per frame
    assert readers.torch_ops_ms_per_unit(run) == pytest.approx(
        (30 + 20 + 20) / 1e3 / 2)
