"""The port's remaining command-line tools against the JAX package's on the
CPU: render_depth, run_semantic, visualize (the static figure and
`--animate`), and the host-only generate_depthmaps, prepare_sfmlearner and
show_2dmap. The same config, sequence, meshes and result.json go through
both packages' `main`; the port's tools that compute run with `--device
cpu`. Tolerances are stated in each test."""
import json
import os
import pickle
import shutil

import cv2
import numpy as np
import pytest
import torch

from visma_tpu_torch.io import VlslamDatasetLoader, load_mat, save_mat, save_obj
from visma_tpu_torch.io.synthetic import SyntheticConfig, write_sequence

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are small: one torch thread is faster than many
    beside the suite's other workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """tests/test_cli.py's sequence: 6 frames, 40 landmarks, images."""
    root = tmp_path_factory.mktemp("toolseq")
    write_sequence(str(root), SyntheticConfig(num_frames=6, num_landmarks=40),
                   write_images=True)
    return str(root)


def _cube(size):
    s = size / 2
    V = np.array([[x, y, z] for x in (-s, s) for y in (-s, s)
                  for z in (-s, s)], np.float32)
    F = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return V, F


# ---------------------------------------------------------------------------
# render_depth
# ---------------------------------------------------------------------------

def _quad():
    V = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                 np.float32)
    return V, np.array([[0, 1, 2], [0, 2, 3]], np.int32)


def _cylinder():
    from visma_tpu_torch.io.procedural import cylinder_mesh

    V, F = cylinder_mesh(0.4, 0.8, segments=12, stacks=3)
    return V.astype(np.float32), F


@pytest.mark.parametrize("mesh,translation", [
    (_quad, [0, 0, 2]), (_cylinder, [0.1, -0.05, 1.6])])
def test_render_depth_equals_reference(tmp_path, mesh, translation):
    """The same config through both tools: coverage agrees on at least
    99.9% of pixels, depth within 1e-3 m where both cover (the tolerances
    of tests/test_torch_render.py), background z_far, and the mask is the
    port's coverage. The quad's centre pixel is tests/test_cli.py's."""
    from visma_tpu.cli import render_depth as J
    from visma_tpu_torch.cli import render_depth as T

    save_obj(str(tmp_path / "m.obj"), *mesh())
    for name, tool, extra in (("t", T, CPU), ("j", J, [])):
        cfg = {"image_height": 48, "image_width": 64, "fx": 40, "fy": 40,
               "cx": 32, "cy": 24, "z_far": 10,
               "mesh": str(tmp_path / "m.obj"), "translation": translation,
               "save": True, "output_path": str(tmp_path / name),
               "mask": True}
        (tmp_path / f"{name}.json").write_text(json.dumps(cfg))
        tool.main([str(tmp_path / f"{name}.json"), *extra])
    dt, dj = (load_mat(str(tmp_path / n / "depthmap.bin")) for n in "tj")
    mt, mj = (load_mat(str(tmp_path / n / "mask.bin")) for n in "tj")
    assert dt.shape == dj.shape == mt.shape == (48, 64)
    assert dt.dtype == np.float32
    ct, cj = dt < 10.0, dj < 10.0
    assert ct.sum() > 100
    assert (ct == cj).mean() >= 0.999
    both = ct & cj
    np.testing.assert_allclose(dt[both], dj[both], atol=1e-3)
    assert (dt[~ct] == 10.0).all()
    np.testing.assert_array_equal(mt, np.where(ct, 255.0, 0.0))
    assert (mt == mj).mean() >= 0.999
    if mesh is _quad:
        assert abs(dt[24, 32] - 2.0) < 1e-2 and mt[24, 32] == 255


# ---------------------------------------------------------------------------
# run_semantic
# ---------------------------------------------------------------------------

def _semantic_gates(out, rec, frames):
    from visma_tpu_torch.io.json_io import matrix_from_json

    assert rec["tracks"] == 1
    assert rec["model"] == "lchair"       # retrieved, bbox had no shape_id
    assert rec["pos_err_m"] < 0.15
    data = json.loads(out.read_text())
    assert len(data) == frames            # one packet per frame
    pose = matrix_from_json(data[-1][0], "model_pose", 3, 4)
    assert pose.shape == (3, 4) and np.isfinite(pose).all()


@pytest.mark.slow
def test_run_semantic_synthetic(tmp_path, capsys):
    """tests/test_cli.py's demo-scene case through the port, held to its
    gates: the CEM draws are the port's own (torch.Generator), so parity
    is the reference test's envelope, not equality. About 40 s on one CPU
    thread: 400 full-frame plain renders."""
    from visma_tpu_torch.cli.run_semantic import main

    out = tmp_path / "result.json"
    main(["--synthetic", "4", "--output", str(out), "--cem-iters", "3",
          "--cem-samples", "32", *CPU])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    _semantic_gates(out, rec, 4)


def test_run_semantic_synthetic_windowed(tmp_path, capsys):
    """The demo scene with the windowed flags (--roi, --roi-spawn,
    --settled, --async-frames) through the port, held to the same gates as
    the reference test's full-frame case."""
    from visma_tpu_torch.cli.run_semantic import main

    out = tmp_path / "result.json"
    mapper = main(["--synthetic", "4", "--output", str(out),
                   "--cem-iters", "3", "--cem-samples", "32",
                   "--roi", "64", "96", "--roi-spawn", "--settled", "2", "16",
                   "--async-frames", "2", *CPU])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    _semantic_gates(out, rec, 4)
    assert mapper.roi == (64, 96) and mapper.settled_iters == 2
    assert mapper.device.type == "cpu"


def test_run_semantic_dataroot(tmp_path, capsys):
    """tests/test_cli.py's real-sequence case: a written synthetic sequence
    with a CAD database on disk (the shape_id path), through the port."""
    from visma_tpu.cli.run_semantic import _demo_meshes as j_demo
    from visma_tpu_torch.cli.run_semantic import _demo_meshes, main

    for (tv, tf), (jv, jf) in zip(_demo_meshes().values(),
                                  j_demo().values()):
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)
    root = tmp_path / "seq"
    write_sequence(str(root), SyntheticConfig(num_frames=3, rows=120,
                                              cols=160))
    models = tmp_path / "models"
    models.mkdir()
    # the synthetic bboxes carry shape_id "chair_0001": provide that mesh
    V, F = _demo_meshes()["lchair"]
    with open(models / "chair_0001.obj", "w") as fp:
        for v in V:
            fp.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for f in F:
            fp.write(f"f {f[0]+1} {f[1]+1} {f[2]+1}\n")

    out = tmp_path / "result.json"
    main(["--dataroot", str(root), "--models", str(models),
          "--output", str(out), "--cem-iters", "2", "--cem-samples", "24",
          "--max-frames", "2", *CPU])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert rec["frames"] == 2
    assert len(json.loads(out.read_text())) == 2


# ---------------------------------------------------------------------------
# visualize
# ---------------------------------------------------------------------------

def test_visualize(seq, tmp_path):
    """The static figure, from the port and from the reference."""
    from visma_tpu.cli.visualize import main as jmain
    from visma_tpu_torch.cli.visualize import main

    main([seq, "--output", str(tmp_path / "t.png")])
    jmain([seq, "--output", str(tmp_path / "j.png")])
    t, j = (cv2.imread(str(tmp_path / f"{n}.png")) for n in "tj")
    assert t is not None and t.shape == j.shape


def test_visualize_animate(seq, tmp_path):
    """tests/test_cli.py's --animate case through both tools on the same
    sequence, CAD directory and result.json: the port's 3 overlay PNGs
    agree with the reference's on at least 99.9% of pixels, and the
    object's edges painted more than 50 coloured pixels."""
    from visma_tpu.cli.visualize import main as jmain
    from visma_tpu_torch.cli.visualize import main

    cad = tmp_path / "cad"
    cad.mkdir()
    V, F = _cube(0.6)
    with open(cad / "cube.obj", "w") as fp:
        for v in V:
            fp.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for f in F:
            fp.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")
    root = tmp_path / "seq"
    shutil.copytree(seq, root)
    G = np.eye(4)
    G[:3, :4] = VlslamDatasetLoader(str(root)).pose(0)
    T_wm = G @ np.array([[1.0, 0, 0, 0], [0, 1, 0, 0],
                         [0, 0, 1, 2.5], [0, 0, 0, 1]])
    packet = [{"id": 0, "model_name": "cube", "status": 2,
               "model_pose": [float(x) for x in T_wm[:3, :4].ravel()]}]
    (root / "result.json").write_text(json.dumps([packet]))

    args = [str(root), "--cad-root", str(cad), "--max-frames", "3"]
    main(args + ["--output", str(tmp_path / "t.png"),
                 "--animate", str(tmp_path / "t"), *CPU])
    jmain(args + ["--output", str(tmp_path / "j.png"),
                  "--animate", str(tmp_path / "j")])
    pngs = sorted((tmp_path / "t").glob("overlay_*.png"))
    assert [p.name for p in pngs] == [
        p.name for p in sorted((tmp_path / "j").glob("overlay_*.png"))]
    assert len(pngs) == 3
    for p in pngs:
        t = cv2.imread(str(p))
        j = cv2.imread(str(tmp_path / "j" / p.name))
        assert t is not None and t.shape == j.shape and t.shape[2] == 3
        assert (t == j).all(axis=2).mean() >= 0.999, p.name
    img = cv2.imread(str(pngs[0])).astype(int)
    colored = (np.abs(img[:, :, 2] - img[:, :, 0]) > 40).sum()
    assert colored > 50, colored


def test_visualize_animate_needs_no_matplotlib(seq, tmp_path, monkeypatch):
    """`--animate` with `--output ''` runs where matplotlib cannot be
    imported, draws no figure, and writes the overlays; asking for the
    figure there fails, after the overlays are written."""
    import sys

    from visma_tpu_torch.cli.visualize import main

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.chdir(tmp_path)
    main([seq, "--max-frames", "2", "--output", "", "--animate", "a", *CPU])
    assert sorted(p.name for p in (tmp_path / "a").glob("*.png")) == [
        "overlay_000000.png", "overlay_000001.png"]
    assert not (tmp_path / "scene.png").exists()
    with pytest.raises(ImportError):
        main([seq, "--max-frames", "2", "--animate", "b", *CPU])
    assert (tmp_path / "b" / "overlay_000001.png").exists()


# ---------------------------------------------------------------------------
# The host-only tools: the reference's output files
# ---------------------------------------------------------------------------

def test_show_2dmap(tmp_path):
    from visma_tpu.cli.show_2dmap import main as jmain
    from visma_tpu_torch.cli.show_2dmap import main

    save_mat(str(tmp_path / "m.bin"),
             np.random.default_rng(0).random((8, 10)).astype(np.float32))
    main([str(tmp_path / "m.bin"), "--output", str(tmp_path / "t.png")])
    jmain([str(tmp_path / "m.bin"), "--output", str(tmp_path / "j.png")])
    t, j = (cv2.imread(str(tmp_path / f"{n}.png")) for n in "tj")
    assert t is not None and t.shape == j.shape


def _depth_inputs(tmp_path, seq):
    """A seeded .xyz cloud in front of the sequence's cameras and a
    result_alignment.json with a non-trivial T_ef_corvis."""
    from scipy.spatial.transform import Rotation

    from visma_tpu_torch.io.json_io import matrix_to_json

    rng = np.random.default_rng(4)
    cloud = rng.uniform([-2.0, -2.0, -0.5], [2.0, 2.0, 2.5], (4000, 3))
    np.savetxt(tmp_path / "cloud.xyz", cloud, fmt="%.6f")
    T = np.eye(4)
    T[:3, :3] = Rotation.from_euler("z", 0.2).as_matrix()
    T[:3, 3] = [0.1, -0.2, 0.05]
    al = {}
    matrix_to_json(al, "T_ef_corvis", T[:3, :4])
    (tmp_path / "align.json").write_text(json.dumps(al))
    return str(tmp_path / "cloud.xyz"), str(tmp_path / "align.json")


def test_generate_depthmaps_equals_reference(seq, tmp_path):
    """Every frame's .depth file byte for byte."""
    from visma_tpu.cli.generate_depthmaps import main as jmain
    from visma_tpu_torch.cli.generate_depthmaps import main

    cloud, align = _depth_inputs(tmp_path, seq)
    main([cloud, align, seq, "--output", str(tmp_path / "t")])
    jmain([cloud, align, seq, "--output", str(tmp_path / "j")])
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) and len(names) == 6
    covered = 0
    for n in names:
        assert n.endswith(".depth")
        b = (tmp_path / "t" / n).read_bytes()
        assert b == (tmp_path / "j" / n).read_bytes(), n
        covered += int((load_mat(str(tmp_path / "t" / n)) < 5.0).sum())
    assert covered > 100


def test_prepare_sfmlearner_equals_reference(seq, tmp_path):
    """With --process-depth on .depth files written by the port's
    generate_depthmaps: the same file names, .jpg by decoded content,
    .pkl and _depth.npy equal."""
    from visma_tpu.cli.prepare_sfmlearner import main as jmain
    from visma_tpu_torch.cli.generate_depthmaps import main as gen
    from visma_tpu_torch.cli.prepare_sfmlearner import main

    root = tmp_path / "seq"
    shutil.copytree(seq, root)
    gen([*_depth_inputs(tmp_path, seq), str(root)])
    for tool, name in ((main, "t"), (jmain, "j")):
        tool([str(root), str(tmp_path / name), "--process-depth"])
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert {n.split(".")[-1] for n in names} == {"jpg", "pkl", "npy"}
    assert len(names) == 3 * 4            # frames 1-4 have both neighbours
    for n in names:
        t, j = tmp_path / "t" / n, tmp_path / "j" / n
        if n.endswith(".jpg"):
            a, b = cv2.imread(str(t)), cv2.imread(str(j))
            assert a.shape == (250, 3 * 480, 3)
            np.testing.assert_array_equal(a, b)
        elif n.endswith(".pkl"):
            a, b = (pickle.loads(p.read_bytes()) for p in (t, j))
            assert a.keys() == b.keys() == {"gwc", "Rg"}
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.load(t), np.load(j))
