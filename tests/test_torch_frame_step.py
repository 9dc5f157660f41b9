"""The VIO frame step (`filter.msckf._frame_step`) reads nothing back to
the host: stepped on CPU tensors under a TorchDispatchMode, it never
dispatches `aten._local_scalar_dense`, the op behind every `.item()`,
`bool(t)` or index with a 0-d tensor, which on the card makes the host
wait for the device. The reference's step is one jitted function with no
such read (visma_tpu/filter/msckf.py:319-417)."""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from visma_tpu_torch.filter import FilterConfig, Msckf, stack_states
from visma_tpu_torch.filter.feed import pack_frames
from visma_tpu_torch.filter.msckf import _frame_step
from visma_tpu_torch.io.synthetic import (SyntheticConfig, make_dataset,
                                          make_imu, make_trajectory)


class _HostReads(TorchDispatchMode):
    """Counts the ops dispatched that read a tensor's value to the host
    (`reads`), and the tensors made from host data (`fresh`: `torch.tensor`
    of a list, an index by a Python list), which on the card are copies
    from pageable memory that a CUDA graph capture refuses."""

    def __init__(self):
        super().__init__()
        self.reads = 0
        self.fresh = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.reads += 1
        if func is torch.ops.aten.lift_fresh.default:
            self.fresh += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    syn = SyntheticConfig(num_frames=6, num_landmarks=120, pixel_noise=0.5,
                          seed=3)
    _, gwc = make_trajectory(syn)
    return syn, make_dataset(syn), make_imu(syn), gwc


@pytest.mark.parametrize("extra", [{}, {"num_slam": 16}, {"use_imu": False}],
                         ids=["default", "slam16", "no_imu"])
def test_frame_step_reads_nothing_back(scene, extra):
    """Five frames of the default config (window 8, 96 tracks, 24
    updates), of 16 SLAM slots and of the IMU-less filter: no host read,
    and a finite state that moved."""
    syn, ds, imu, gwc = scene
    cfg = FilterConfig(window=8, max_tracks=96, max_updates=24, fx=syn.fx,
                       fy=syn.fy, cx=syn.cx, cy=syn.cy, **extra)
    frames = pack_frames(cfg, ds, imu, max_feats=96)
    state = Msckf(cfg, device="cpu").init(R0=gwc[0, :, :3], p0=gwc[0, :, 3],
                                          v0=imu["v0"])
    p0 = state.p.clone()
    mode = _HostReads()
    with mode:
        for i in range(1, 6):
            state = _frame_step(cfg, state, {
                k: torch.as_tensor(v[i]) for k, v in frames.items()
                if k != "ts"})
    assert mode.reads == 0
    assert bool(torch.isfinite(state.p).all())
    assert float((state.p - p0).norm()) > 0.01


def test_frame_gyro_gather_under_vmap(scene):
    """The body-rate gather batches under `torch.func.vmap` (the step of
    `Msckf.run_batched`), with frames of different sample counts: each row
    equals its own unbatched step."""
    syn, ds, imu, gwc = scene
    cfg = FilterConfig(window=6, max_tracks=48, max_updates=12, fx=syn.fx,
                       fy=syn.fy, cx=syn.cx, cy=syn.cy)
    frames = {k: torch.as_tensor(v) for k, v in
              pack_frames(cfg, ds, imu, max_feats=48).items() if k != "ts"}
    kf = Msckf(cfg, device="cpu")
    state = kf.init(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=imu["v0"])
    # the second stream's frame has its last two IMU samples masked off
    a = {k: v[1] for k, v in frames.items()}
    b = dict(a, dts=a["dts"].clone())
    b["dts"][-2:] = 0
    assert int((a["dts"] > 0).sum()) != int((b["dts"] > 0).sum())
    step = torch.func.vmap(lambda s, f: _frame_step(cfg, s, f))
    out = step(stack_states([state, state]),
               {k: torch.stack([a[k], b[k]]) for k in a})
    for row, f in enumerate((a, b)):
        one = _frame_step(cfg, state, f)
        np.testing.assert_allclose(out.p[row].numpy(), one.p.numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(out.R[row].numpy(), one.R.numpy(),
                                   atol=1e-6)
