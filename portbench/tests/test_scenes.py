"""The scenes are made from the seed alone: the same seed gives the same
inputs, another seed other inputs, of the same sizes."""
import numpy as np
import pytest
import torch

from portbench.reference.vio.undistort import corvis_table
from portbench.entries import vio_common
from portbench.scenes import vio as scenes
from portbench import harness

_, CONFIG, _ = harness.load_cell(harness.load_bench(), "vio.seq")
CAM, SCENE = CONFIG["camera"], CONFIG["scene"]


def _raw(seed):
    K_out, _ = corvis_table(CAM)
    inv = torch.as_tensor(scenes.inverse_atan_table(CAM, K_out))
    return scenes.raw_sequence(SCENE, CAM, K_out, inv, seed, 3)


def test_raw_sequence_is_the_seeds():
    a, b, c = _raw(2 ** 31 + 5), _raw(2 ** 31 + 5), _raw(2 ** 31 + 6)
    assert a["raw"].shape == (3, CAM["in_rows"], CAM["in_cols"])
    assert a["raw"].dtype == torch.uint8
    assert torch.equal(a["raw"], b["raw"])
    assert np.array_equal(a["gyro"], b["gyro"])
    assert not torch.equal(a["raw"], c["raw"])
    assert c["raw"].shape == a["raw"].shape


def test_feeds_are_the_seeds():
    K = vio_common.ref.cropped_camera(CAM)

    def feeds(seed):
        return scenes.feature_feeds(SCENE, K, CAM["final_rows"],
                                    CAM["out_cols"], seed, 3, 5, 96,
                                    torch.device("cpu"))["frames"]
    a, b, c = feeds(7), feeds(7), feeds(8)
    for k in a:
        assert torch.equal(a[k], b[k])
        assert a[k].shape == c[k].shape
    assert not torch.equal(a["xp"], c["xp"])
    assert bool((a["valid"] == (a["ids"] >= 0)).all())
    assert int(a["valid"][:, 1:].sum(-1).min()) == 96


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 17])
def test_orbit_integrates_onto_its_poses(seed):
    traj = scenes.orbit(SCENE, 4, 0.3 * seed % 6)
    assert traj["gyro"].shape == (3 * SCENE["imu_samples_per_frame"], 3)
    R = traj["R"]
    assert np.allclose(R @ R.transpose(0, 2, 1), np.eye(3), atol=1e-12)


def test_semantic_scene_is_the_seeds():
    from portbench.scenes import semantic
    a, b, c = (semantic.objects(4, s) for s in (3, 3, 4))
    assert a[0] == ["chair", "desk", "chair", "desk"]
    assert np.array_equal(a[1], b[1]) and not np.array_equal(a[1], c[1])
    path = [semantic.path_index(i, 4) for i in range(8)]
    assert path == [0, 1, 2, 3, 2, 1, 0, 1]


def test_binned_raster_is_the_plain_one():
    """The reference's raster over each subtile's chunks gives the bytes of
    the plain every-pixel-every-chunk evaluation."""
    from portbench.reference.semantic import raster
    from portbench.scenes import semantic
    db = semantic.mesh_db()
    Vs, Fs = raster.pad_mesh_stack([db[n] for n in db])
    Cs = torch.as_tensor(raster.face_corner_stack(Vs, Fs))
    intr = raster.Intrinsics(121.6, 133.85, 117.3, 64.48, 125, 240, 0.05, 8.0)
    _, T, _ = semantic.objects(2, 5)
    poses = torch.as_tensor(
        semantic.model_to_camera(T, semantic.strafe(1, 0.015)[0]))
    planes, ids, counts = raster._prep_chunks_all(
        Cs[torch.tensor([0, 1])], poses, intr, 128, sub_px=32)
    got = raster._evaluate(planes, ids, counts, intr, 32)
    assert torch.equal(got, raster.chunk_raster_plain(planes, intr))
    assert int(torch.isfinite(got).sum()) > 500
