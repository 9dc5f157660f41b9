"""The port's checkpoints (visma_tpu_torch.utils.checkpoint) and the
kill-and-recover drill of dist/multihost.py on the CPU.

Round trips of `BaProblem`, `FilterState` and `PipelineState`; a file the
port writes read by the JAX package's `load_state`, and a file in the JAX
package's npz layout (its `save_state` without orbax) read by the port,
leaf for leaf; then the drill of tests/test_multihost.py:111-158 at 8 x 64:
a checkpointing worker (this file's `__main__` branch) is SIGKILLed after
step 2, the `Watchdog` respawns it, it resumes from its npz, and its final
state equals an uninterrupted run's to 1e-6.
"""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
TOTAL_STEPS = 6


FILTER = dict(window=4, max_tracks=16, fx=120.0, fy=120.0, cx=80.0, cy=64.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are small: one torch thread is faster than many
    beside the suite's other workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves_np(tree):
    from visma_tpu_torch.utils.misc import tree_leaves

    return [x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in tree_leaves(tree)]


def _port_state(kind, seed=0):
    """A port state of `kind` with values that depend on `seed`."""
    from visma_tpu_torch.ba.problem import synthetic_ba_problem
    from visma_tpu_torch.filter.config import FilterConfig
    from visma_tpu_torch.filter.msckf import Msckf
    from visma_tpu_torch.pipeline import VioPipeline

    if kind == "ba":
        return synthetic_ba_problem(8, 64, 0.5, 0.02, seed=seed,
                                    device="cpu")[0]
    rng = np.random.default_rng(seed)
    if kind == "filter":
        return Msckf(FilterConfig(**FILTER), device="cpu").init(
            p0=rng.standard_normal(3), v0=rng.standard_normal(3))
    image = rng.uniform(0, 255, (64, 80)).astype(np.float32)
    return VioPipeline(FilterConfig(**FILTER), levels=2, cell=16,
                       device="cpu").init(image, p0=rng.standard_normal(3))


def _reference_state(kind):
    """The JAX package's state of the same structure (the template its
    load_state fills)."""
    import jax.numpy as jnp

    from visma_tpu.ba.problem import synthetic_ba_problem
    from visma_tpu.filter import FilterConfig, Msckf
    from visma_tpu.pipeline import VioPipeline

    if kind == "ba":
        return synthetic_ba_problem(8, 64, 0.5, 0.02)[0]
    if kind == "filter":
        return Msckf(FilterConfig(**FILTER)).init()
    return VioPipeline(FilterConfig(**FILTER), levels=2, cell=16).init(
        jnp.zeros((64, 80), jnp.float32))


KINDS = ["ba", "filter", "pipeline"]


@pytest.mark.parametrize("kind", KINDS)
def test_round_trip(kind, tmp_path):
    """save_state, then load_state into another state of the same shapes:
    every leaf comes back with its dtype, device and bytes; latest_step
    names the last step saved."""
    from visma_tpu_torch.utils.checkpoint import (latest_step, load_state,
                                                  save_state)

    state = _port_state(kind, seed=1)
    save_state(str(tmp_path), _port_state(kind, seed=2), step=3)
    save_state(str(tmp_path), state, step=7)
    assert latest_step(str(tmp_path)) == 7
    back = load_state(str(tmp_path), _port_state(kind, seed=3))
    assert type(back) is type(state)
    for got, ref in zip(_leaves_np(back), _leaves_np(state)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    older = load_state(str(tmp_path), state, step=3)
    for got, ref in zip(_leaves_np(older), _leaves_np(_port_state(kind, 2))):
        np.testing.assert_array_equal(got, ref)


def test_dicts_and_sequences_flatten_like_the_reference(tmp_path):
    """Dict keys in sorted order, tuples and lists in order, None without a
    leaf: the order of jax.tree_util.tree_flatten."""
    import jax

    from visma_tpu_torch.utils.checkpoint import load_state, save_state
    from visma_tpu_torch.utils.misc import tree_leaves

    tree = {"b": (np.arange(3), None, [np.ones(2, np.float32)]),
            "a": torch.tensor([4, 5], dtype=torch.int32), "c": 2.5}
    ref = jax.tree_util.tree_leaves(tree)
    got = tree_leaves(tree)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    save_state(str(tmp_path), tree, step=1)
    back = load_state(str(tmp_path), tree)
    assert list(back) == ["b", "a", "c"] and back["b"][1] is None
    assert isinstance(back["a"], torch.Tensor) and back["c"] == 2.5


@pytest.mark.parametrize("kind", KINDS)
def test_port_file_loads_in_the_reference(kind, tmp_path):
    import jax

    from visma_tpu.utils.checkpoint import load_state as j_load_state

    from visma_tpu_torch.utils.checkpoint import save_state

    state = _port_state(kind, seed=4)
    save_state(str(tmp_path), state, step=5)
    back = j_load_state(str(tmp_path), _reference_state(kind))
    ref_leaves = jax.tree_util.tree_leaves(back)
    mine = _leaves_np(state)
    assert len(ref_leaves) == len(mine)
    for got, ref in zip(ref_leaves, mine):
        got = np.asarray(got)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", KINDS)
def test_reference_npz_loads_in_the_port(kind, tmp_path, monkeypatch):
    """The JAX package's save_state writes its npz container when orbax is
    missing (checkpoint.py:45-47); the port reads it into its own state."""
    import jax

    from visma_tpu.utils.checkpoint import save_state as j_save_state

    from visma_tpu_torch.utils.checkpoint import load_state

    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    ref = _reference_state(kind)
    j_save_state(str(tmp_path), ref, step=2)
    assert (tmp_path / "step_2.npz").is_file()
    back = load_state(str(tmp_path), _port_state(kind, seed=5))
    for got, want in zip(_leaves_np(back), jax.tree_util.tree_leaves(ref)):
        want = np.asarray(want)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_wrong_template_is_refused(tmp_path):
    from visma_tpu_torch.utils.checkpoint import load_state, save_state

    save_state(str(tmp_path), _port_state("ba"), step=1)
    with pytest.raises(ValueError, match="leaves"):
        load_state(str(tmp_path), _port_state("filter"))


def test_interrupted_save_keeps_the_last_snapshot(tmp_path, monkeypatch):
    """A save cut off while it writes `latest.json` (a worker killed
    mid-save, as the drill kills one) leaves the previous step readable:
    the file is replaced in one rename, never truncated in place."""
    from visma_tpu_torch.utils import checkpoint
    from visma_tpu_torch.utils.checkpoint import (latest_step, load_state,
                                                  save_state)

    tree = _port_state("ba")
    save_state(str(tmp_path), tree, step=1)

    def cut(*args, **kwargs):
        raise OSError("cut off mid-write")

    monkeypatch.setattr(checkpoint.json, "dump", cut)
    with pytest.raises(OSError, match="mid-write"):
        save_state(str(tmp_path), tree, step=2)
    monkeypatch.undo()
    assert latest_step(str(tmp_path)) == 1
    for a, b in zip(_leaves_np(load_state(str(tmp_path), tree)),
                    _leaves_np(tree)):
        np.testing.assert_array_equal(a, b)


# ---- the kill-and-recover drill (tests/test_multihost.py:111-158) --------

def _worker(workdir, total_steps, step_sleep):
    """Runs `total_steps` sharded-BA GN steps (one-rank mesh, CPU) one at a
    time, checkpointing the whole BaProblem after every step and touching a
    heartbeat; on a (re)start it resumes from the latest snapshot."""
    torch.set_num_threads(1)
    from visma_tpu_torch.ba.problem import synthetic_ba_problem
    from visma_tpu_torch.dist import make_mesh, sharded_ba_step
    from visma_tpu_torch.dist.multihost import Heartbeat
    from visma_tpu_torch.utils.checkpoint import (latest_step, load_state,
                                                  save_state)

    ckpt = os.path.join(workdir, "ckpt")
    hb = Heartbeat(os.path.join(workdir, "heartbeat"), interval_s=0.0)
    prob, _ = synthetic_ba_problem(8, 64, 0.5, 0.02, device="cpu")
    start = 0
    try:
        start = latest_step(ckpt)
    except OSError:
        pass
    if start > 0:
        prob = load_state(ckpt, prob, step=start)
        print(f"worker: resumed from step {start}")
    mesh = make_mesh(device="cpu")
    for step in range(start, total_steps):
        prob, _ = sharded_ba_step(prob, mesh, damping=1e-3)
        save_state(ckpt, prob, step=step + 1)
        hb.touch(step + 1)
        if step_sleep:
            time.sleep(step_sleep)
    np.savez(os.path.join(workdir, "final.npz"), p=prob.p.numpy(),
             X=prob.X.numpy())


def _spawn(workdir, sleep_s):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, __file__, str(workdir), str(TOTAL_STEPS),
         str(sleep_s)], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)


def test_kill_and_recover_equals_uninterrupted(tmp_path):
    from visma_tpu_torch.dist.multihost import Watchdog

    clean = tmp_path / "clean"
    clean.mkdir()
    p = _spawn(clean, 0.0)
    out, _ = p.communicate(timeout=120)
    assert p.returncode == 0, out.decode()
    ref = np.load(clean / "final.npz")

    drill = tmp_path / "drill"
    drill.mkdir()
    latest = drill / "ckpt" / "latest.json"
    victim = _spawn(drill, 0.3)
    deadline = time.time() + 120
    while time.time() < deadline:
        if latest.exists() and json.loads(latest.read_text())["step"] >= 2:
            break
        time.sleep(0.05)
    else:
        victim.kill()
        victim.wait()
        pytest.fail("the worker wrote no checkpoint")
    os.kill(victim.pid, signal.SIGKILL)  # the exact pid we spawned
    victim.wait()
    assert victim.returncode != 0
    assert not (drill / "final.npz").exists()

    resumed = []

    def respawn():
        resumed.append(_spawn(drill, 0.0))
        return resumed[-1]

    wd = Watchdog(respawn, heartbeat_path=str(drill / "heartbeat"),
                  stale_timeout_s=60.0, poll_s=0.2, max_restarts=2)
    assert wd.run() == 0
    log = resumed[-1].communicate(timeout=30)[0].decode()
    assert "resumed from step" in log, log
    got = np.load(drill / "final.npz")
    np.testing.assert_allclose(got["p"], ref["p"], atol=1e-6)
    np.testing.assert_allclose(got["X"], ref["X"], atol=1e-6)


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), float(sys.argv[3]))
