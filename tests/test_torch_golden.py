"""The port's loader and example tools on the golden fixture: the checked-in
tests/data/golden_seq directory, encoded once with the reference's
protoc-compiled schema, against its expected.json. The twin of
tests/test_golden.py's loader and CLI cases for `visma_tpu_torch.io`; the
native-decoder cases have no twin, since the port decodes with the Python
codec only. All on the CPU, a few seconds."""
import json
import pathlib

import numpy as np
import pytest

GOLDEN = pathlib.Path(__file__).parent / "data" / "golden_seq"


@pytest.fixture(scope="module")
def expected():
    return json.loads((GOLDEN / "expected.json").read_text())


@pytest.fixture(scope="module")
def loader():
    from visma_tpu_torch.io import VlslamDatasetLoader

    return VlslamDatasetLoader(str(GOLDEN))


class TestGoldenLoader:
    def test_size_and_camera(self, loader, expected):
        assert len(loader) == expected["n_frames"]
        cam = loader.grab_camera_info()
        assert cam.rows == expected["rows"] and cam.cols == expected["cols"]
        p = np.asarray(cam.parameters)
        np.testing.assert_allclose(
            p[:4], [expected["fx"], expected["fy"],
                    expected["cx"], expected["cy"]])

    def test_pose_and_gravity(self, loader, expected):
        gwc = loader.pose(3)
        np.testing.assert_allclose(
            gwc, np.asarray(expected["gwc_frame3"]).reshape(3, 4),
            rtol=1e-6)
        # Rg = exp([wg0, wg1, 0]) (dataloader.cpp:107-109)
        from scipy.spatial.transform import Rotation

        Rg = loader.gravity_rotation(0)
        want = Rotation.from_rotvec([0.02, -0.01, 0.0]).as_matrix()
        np.testing.assert_allclose(Rg, want, atol=1e-6)

    def test_grab_full_frame(self, loader, expected):
        fr = loader.grab(0)
        assert fr.ts == expected["first_ts"]
        assert fr.image is not None and fr.image.shape == (
            expected["rows"], expected["cols"], 3)
        assert fr.edgemap is not None and fr.edgemap.shape == (
            expected["rows"], expected["cols"])
        assert 0.0 <= fr.edgemap.min() and fr.edgemap.max() <= 1.0
        assert fr.bboxlist is not None
        bbs = fr.bboxlist.bounding_boxes
        assert len(bbs) == 2
        assert bbs[0].class_name == "chair" and bbs[0].label == 62
        assert bbs[0].shape_id == "aeron"
        np.testing.assert_allclose(np.asarray(bbs[0].scores), [0.9, 0.05],
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(bbs[0].azimuth_prob),
                                   [0.2, 0.8], atol=1e-6)

    def test_feature_geometry_consistent(self, loader, expected):
        """Stored xp equals the projection of xw through gwc, the invariant
        the fixture was built with: a decoding fault anywhere in the chain
        breaks it."""
        fr = loader.grab(5, load_image=False)
        pk = loader.dataset.packets[5]
        R, t = fr.gwc[:, :3], fr.gwc[:, 3]
        fx, fy, cx, cy = expected["fx"], expected["fy"], \
            expected["cx"], expected["cy"]
        assert len(pk.features) == expected["n_features"]
        for f in pk.features:
            Xc = R.T @ (np.asarray(f.xw[:3]) - t)
            xp = [fx * Xc[0] / Xc[2] + cx, fy * Xc[1] / Xc[2] + cy]
            np.testing.assert_allclose(np.asarray(f.xp[:2]), xp, atol=1e-4)

    def test_sparse_depth_positive(self, loader):
        sd = loader.grab_sparse_depth(0)
        assert len(sd) > 0
        for fid, (x, y, z) in sd.items():
            assert z > 0  # all fixture points are in front of the camera

    def test_packed_python_path(self, loader, expected):
        packed = loader.packed_packets(max_features=16)
        N = expected["n_frames"]
        assert packed["gwc"].shape == (N, 3, 4)
        assert packed["feat_xw"].shape == (N, 16, 3)
        np.testing.assert_allclose(
            packed["feat_xw"][0, 0], expected["feat0_xw"], rtol=1e-6)
        # EMPTY (=0) marks unused slots beyond the real 12 features
        assert (packed["feat_status"][:, expected["n_features"]:] == 0).all()
        assert (packed["feat_status"][:, :expected["n_features"]] > 0).all()


class TestGoldenCli:
    def test_example_load(self, capsys):
        from visma_tpu_torch.cli.example_load import main

        main([str(GOLDEN), "--max-frames", "2"])
        out = capsys.readouterr().out
        assert "10 frames" in out and "bbox chair" in out

    def test_example_dump(self, tmp_path):
        from visma_tpu_torch.cli.example_dump import main

        main([str(GOLDEN), str(tmp_path / "out")])
        K = np.loadtxt(tmp_path / "out" / "K.txt")
        assert K[0, 0] == 60.0
        G = np.loadtxt(tmp_path / "out" / "pose" / "000000.txt")
        assert G.shape == (4, 4)
        np.testing.assert_allclose(G[:3, :3], np.eye(3), atol=1e-6)
        assert (tmp_path / "out" / "image" / "000000.jpg").exists()
        assert (tmp_path / "out" / "depth" / "000003.txt").exists()
