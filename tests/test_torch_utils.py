"""The port's utils (visma_tpu_torch.utils: Timer, TermColor, the misc
helpers, utils.logging) against the JAX package's on the CPU: the cases of
tests/test_utils.py through the port, and the same seeded inputs through
both packages, with the tolerance stated in each test."""
import json
import logging
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visma_tpu import utils as J
from visma_tpu.utils import logging as JL
from visma_tpu_torch import utils as T
from visma_tpu_torch.utils import logging as TL


def test_timer_accumulates():
    t = T.Timer("test")
    for _ in range(3):
        t.tick("ev")
        time.sleep(0.01)
        t.tock("ev")
    assert 8 < t.mean_ms("ev") < 100
    assert t.report()["ev"]["count"] == 3
    assert "ev" in str(t)


def test_timer_scope():
    t = T.Timer()
    with t.scope("s"):
        time.sleep(0.005)
    assert t.mean_ms("s") > 3


@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_any_nan_on_a_tree(kind):
    """tests/test_utils.py's tree through the port, in torch tensors and in
    numpy arrays, beside the reference's answer on the same values; integer
    leaves are not looked at."""
    arr = torch.as_tensor if kind == "torch" else np.asarray
    good = {"a": arr(np.ones(3, np.float32)),
            "b": [arr(np.zeros((2, 2), np.float32))],
            "n": arr(np.array([1, 2]))}
    bad = {"a": arr(np.array([1.0, np.nan], np.float32))}
    inf = (arr(np.zeros(2)), [arr(np.array([np.inf]))])
    for tree, want in ((good, False), (bad, True), (inf, True)):
        assert T.any_nan(tree) is want
        jtree = {"x": [jnp.asarray(np.asarray(x)) for x in
                       T.misc.tree_leaves(tree)]}
        assert J.any_nan(jtree) is want
    assert T.any_nan(None) is False


def test_bilinear_sample():
    img = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    v = T.bilinear_sample(img, torch.tensor([1.5, 0.5]))
    assert abs(float(v) - 3.5) < 1e-5  # avg of 1,2,5,6


def test_bilinear_sample_equals_reference():
    """64 seeded coordinates, some outside the image (the reference clips
    the taps to [0, W-2] x [0, H-2]), in a (8, 8, 2) batch: 1e-6."""
    rng = np.random.default_rng(11)
    img = rng.normal(size=(13, 17)).astype(np.float32)
    xy = np.stack([rng.uniform(-2, 19, 64), rng.uniform(-2, 15, 64)],
                  axis=-1).astype(np.float32).reshape(8, 8, 2)
    got = T.bilinear_sample(torch.as_tensor(img), torch.as_tensor(xy))
    want = np.asarray(J.bilinear_sample(jnp.asarray(img), jnp.asarray(xy)))
    assert got.shape == (8, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_colors_and_misc():
    s = T.TermColor.wrap("x", T.TermColor.red)
    assert s.startswith("\033[91m") and s.endswith("\033[0m")
    cm = T.generate_random_color_map(8)
    assert len(cm) == 8 and cm[0].shape == (3,)
    m = T.random_matrix(3, 4)
    assert m.shape == (3, 4) and (np.abs(m) <= 1).all()


@pytest.mark.parametrize("seed", [0, 5])
def test_random_helpers_equal_reference(seed):
    np.testing.assert_array_equal(T.random_matrix(4, 6, 2.5, seed),
                                  J.random_matrix(4, 6, 2.5, seed))
    np.testing.assert_array_equal(T.random_vector(7, 0.5, seed),
                                  J.random_vector(7, 0.5, seed))
    tc, jc = (T.generate_random_color_map(32, seed),
              J.generate_random_color_map(32, seed))
    assert tc.keys() == jc.keys()
    for k in tc:
        assert tc[k].dtype == np.uint8
        np.testing.assert_array_equal(tc[k], jc[k])


def test_utils_exports_the_reference_names():
    assert set(J.__all__) <= set(T.__all__)


def test_check_raises_and_metrics_writer_logs(tmp_path, caplog):
    """`check` raises with its message; MetricsWriter writes one JSON line
    a record, with the throughput and weak-scaling sums of the
    reference's."""
    assert TL.get_logger().name == "visma_tpu_torch"
    TL.check(True, "fine")
    with caplog.at_level(logging.ERROR, logger="visma_tpu_torch"):
        with pytest.raises(AssertionError, match="frames lost"):
            TL.check(False, "frames lost")
    assert "CHECK failed: frames lost" in caplog.text

    recs = {}
    for name, mod in (("t", TL), ("j", JL)):
        path = tmp_path / f"{name}.jsonl"
        w = mod.MetricsWriter(str(path))
        w.log(stage="vio", frames=3)
        tp = w.throughput(frames=120, seconds=4.0, chips=4)
        eff = w.scaling_efficiency(2.0, 2.5, 1, 4)
        w._fp.close()
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        recs[name] = (tp, eff, [{k: v for k, v in r.items() if k != "t"}
                                for r in lines])
    assert recs["t"] == recs["j"]
    tp, eff, lines = recs["t"]
    assert tp == {"frames_per_sec": 30.0, "frames_per_sec_per_chip": 7.5,
                  "chips": 4}
    assert abs(eff - 0.8) < 1e-12 and len(lines) == 3
    assert lines[0] == {"stage": "vio", "frames": 3}


def test_trace_union_check_and_takes(monkeypatch):
    """`utils.trace`: the busy time is the union of the operations'
    intervals (two streams' overlap counted once) beside their sum; the
    check holds the operations to the host's launches and the runners'
    replayed ops (exactly; at least one op a launch of another graph);
    `traced`
    takes a trace that fails the check again and raises after `takes`
    failures."""
    from visma_tpu_torch.utils import trace as TT

    ops = [("a", 0.0, 10.0), ("b", 5.0, 15.0), ("c", 20.0, 22.0),
           ("d", 30.0, 30.0)]
    t = TT.Trace(ops=ops, host_launches=4, graph_launches=0,
                 spans=[("vio.step", 0.0, 3000.0),
                        ("vio.step", 5000.0, 6000.0)])
    assert t.busy_ms() == pytest.approx((0.017, 0.022))
    assert t.check().startswith("4 device ops traced")
    assert t.top(1) == [("a", 10.0, 1)]
    assert t.span_ms() == [("vio.step", pytest.approx(4.0), 2)]
    with pytest.raises(RuntimeError, match="lost device records"):
        TT.Trace(ops=ops, host_launches=5, graph_launches=0).check()
    # graphs of other makers: at least one op a launch
    TT.Trace(ops=ops, host_launches=2, graph_launches=2).check()
    with pytest.raises(RuntimeError, match="lost device records"):
        TT.Trace(ops=ops, host_launches=3, graph_launches=2).check()
    # the runners' replays: exactly the ops their captures recorded
    assert TT.Trace(ops=ops, host_launches=1, graph_launches=2, replays=2,
                    replay_ops=3).check().endswith("of 3 device ops")
    with pytest.raises(RuntimeError, match="lost device records"):
        TT.Trace(ops=ops, host_launches=1, graph_launches=2, replays=2,
                 replay_ops=4).check()
    assert TT.Trace(ops=[], host_launches=0,
                    graph_launches=0).busy_ms() == (None, None)

    takes = iter([5, 5, 4, 5, 5, 5])
    monkeypatch.setattr(TT, "_trace", lambda *a: TT.Trace(
        ops=ops, host_launches=next(takes), graph_launches=0))
    got = TT.traced(lambda: None)
    assert got.host_launches == 4 and len(got.lost) == 2
    with pytest.raises(RuntimeError, match="3 takes"):
        TT.traced(lambda: None)
