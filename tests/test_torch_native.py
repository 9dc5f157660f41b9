"""The port's native decoder binding (visma_tpu_torch.io.native_loader) and
its `vlslam_pb2` shim on the CPU: tests/test_native.py's cases (all but the
timing one) and tests/test_golden.py's shim cases through the port, each
held to the port's Python codec and to the JAX package's output on the
same bytes."""
import pathlib

import numpy as np
import pytest

from visma_tpu.io import native_loader as JN
from visma_tpu_torch.io import native_loader as TN
from visma_tpu_torch.io.loader import VlslamDatasetLoader
from visma_tpu_torch.io.synthetic import SyntheticConfig, make_dataset
from visma_tpu_torch.proto import EdgeMap

GOLDEN = pathlib.Path(__file__).parent / "data" / "golden_seq"
KEYS = ("ts", "gwc", "wg", "feat_id", "feat_status", "feat_xp", "feat_xw")


@pytest.fixture(scope="module")
def native():
    """Builds the decoder (make -C native) on first use, inside the test
    run rather than at import; skips where it cannot be built."""
    if not TN.available():
        pytest.skip("native decoder not built")


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """tests/test_native.py's 20-frame dataset, written as a sequence."""
    root = tmp_path_factory.mktemp("native")
    data = make_dataset(SyntheticConfig(num_frames=20, num_landmarks=80,
                                        seed=9)).encode()
    (root / "dataset").write_bytes(data)
    return root, data


def test_dataset_matches_python_codec(native, seq):
    """The port's native arrays equal its Python codec's and the JAX
    package's native decoder's bit for bit (the reference's own test
    allows 1e-6 / 1e-5 on the floats; none is needed)."""
    root, data = seq
    got = TN.packed_packets_native(data, max_features=128)
    py = VlslamDatasetLoader(str(root)).packed_packets(max_features=128,
                                                       native=False)
    ref = JN.packed_packets_native(data, max_features=128)
    assert set(got) == set(ref) == set(KEYS) | {"feat_count"}
    for k in KEYS:
        assert got[k].dtype == py[k].dtype, k
        np.testing.assert_array_equal(got[k], py[k], err_msg=k)
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("max_features", [16, 256])
def test_packed_packets_native_equals_python(native, seq, max_features):
    """`packed_packets(native=True)` (the default) equals `native=False`
    bit for bit, with the feature table cut below the frames' count and
    padded above it."""
    loader = VlslamDatasetLoader(str(seq[0]))
    a = loader.packed_packets(max_features=max_features)
    b = loader.packed_packets(max_features=max_features, native=False)
    assert set(a) == set(b) == set(KEYS)
    for k in KEYS:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_edgemap_native(native):
    em = EdgeMap(rows=48, cols=64,
                 data=np.linspace(0, 1, 48 * 64).astype(np.float32))
    out = TN.load_edgemap_native(em.encode())
    np.testing.assert_array_equal(out, em.as_image())
    data = sorted(GOLDEN.glob("*.edge"))[0].read_bytes()
    np.testing.assert_array_equal(TN.load_edgemap_native(data),
                                  EdgeMap.decode(data).as_image())


def test_malformed_buffer_rejected(native):
    with pytest.raises(ValueError):
        TN.packed_packets_native(b"\x1a\xffgarbage_that_is_not_proto")
    with pytest.raises(ValueError):
        TN.load_edgemap_native(b"\x08\xff\xff")


# ---------------------------------------------------------------------------
# vlslam_pb2 on the golden fixture (tests/test_golden.py:129-186)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def expected():
    import json

    return json.loads((GOLDEN / "expected.json").read_text())


def test_pb2_dataset_parse_like_reference_script(expected):
    from visma_tpu_torch.proto import vlslam_pb2

    dataset = vlslam_pb2.Dataset()
    n = dataset.ParseFromString((GOLDEN / "dataset").read_bytes())
    assert n > 0
    assert len(dataset.packets) == expected["n_frames"]
    packet = dataset.packets[3]
    gwc = np.array(packet.gwc).reshape(3, 4)
    np.testing.assert_allclose(gwc.ravel(), expected["gwc_frame3"],
                               rtol=1e-6)
    wg = np.array([packet.wg[0], packet.wg[1], 0.0])
    assert wg.shape == (3,)
    f = packet.features[0]
    assert f.id == 1000
    np.testing.assert_allclose(np.array(f.xw)[:3], expected["feat0_xw"],
                               rtol=1e-6)
    assert dataset.camera.rows == expected["rows"]


def test_pb2_edgemap_parse_like_reference_utils():
    from visma_tpu_torch.proto import vlslam_pb2

    path = sorted(GOLDEN.glob("*.edge"))[0]
    edgemap = vlslam_pb2.EdgeMap()
    edgemap.ParseFromString(path.read_bytes())
    em = np.array(edgemap.data).reshape(edgemap.rows, edgemap.cols)
    assert em.shape == (48, 64)
    assert 0.0 <= em.min() and em.max() <= 1.0


def test_pb2_enum_constants_and_roundtrip():
    from visma_tpu.proto import vlslam_pb2 as J
    from visma_tpu_torch.proto import Dataset, vlslam_pb2

    assert vlslam_pb2.Feature.INSTATE == 6
    assert vlslam_pb2.Feature.EMPTY == 0
    for name in ("EMPTY", "INSTATE", "GOODDROP"):
        assert getattr(vlslam_pb2.Feature, name) == getattr(J.Feature, name)
    blob = (GOLDEN / "dataset").read_bytes()
    ds = vlslam_pb2.Dataset()
    ds.ParseFromString(blob)
    out = ds.SerializeToString()
    jds = J.Dataset()
    jds.ParseFromString(blob)
    assert out == jds.SerializeToString()
    again = Dataset.decode(out)
    assert len(again.packets) == len(ds.packets)
    np.testing.assert_allclose(np.array(again.packets[3].gwc),
                               np.array(ds.packets[3].gwc))


def test_pb2_bbox_parse():
    from visma_tpu_torch.proto import vlslam_pb2

    path = sorted(GOLDEN.glob("*.bbox"))[0]
    bl = vlslam_pb2.BoundingBoxList()
    bl.ParseFromString(path.read_bytes())
    assert len(bl.bounding_boxes) == 2
    bb = bl.bounding_boxes[0]
    assert bb.class_name == "chair" and bb.shape_id == "aeron"


def test_pb2_copy_from_is_deep():
    """CopyFrom copies through the wire: a later change to either message
    does not reach the other."""
    from visma_tpu_torch.proto import vlslam_pb2

    src = vlslam_pb2.Dataset()
    src.ParseFromString((GOLDEN / "dataset").read_bytes())
    dst = vlslam_pb2.Dataset()
    dst.CopyFrom(src)
    assert dst.SerializeToString() == src.SerializeToString()
    n = len(src.packets)
    src.packets.pop()
    assert len(dst.packets) == n and len(src.packets) == n - 1
