"""The port's fused CEM loop against its host oracle on the scene of
tests/test_torch_semantic.py (whose `scene` fixture it shares). The case
is the slowest of the fast tier on the CPU, so it has a file of its own:
under `--dist loadfile` it then runs on a worker beside the rest of the
semantic tests instead of after them."""
import numpy as np
import pytest
import torch

from test_torch_semantic import scene  # noqa: F401  (the shared fixture)
from visma_tpu_torch.semantic import cem as TCEM


def test_device_loop_agrees_with_host_oracle_on_quality(scene):
    """The fused loop with its own torch.Generator lands where the host
    oracle lands (different draws: a quality bound, not parity), returns
    tensors, and is reproducible from its seed."""
    s = scene
    init = s["poses"].copy()
    init[:, 0, 3] += 0.03
    kw = dict(iters=3, samples=12, init_sigma=(0.08, 0.04), seed=3,
              roi=(48, 64), occluder_poses=init, device="cpu")
    p1, s1 = TCEM.refine_pose_cem_batched(s["tr"], s["obs"], init, s["mi"],
                                          **kw)
    p2, _ = TCEM.refine_pose_cem_batched(s["tr"], s["obs"], init, s["mi"],
                                         **kw)
    assert isinstance(p1, torch.Tensor) and p1.shape == (3, 3, 4)
    np.testing.assert_array_equal(p1.numpy(), p2.numpy())
    ph, sh = TCEM.refine_pose_cem_batched(s["tr"], s["obs"], init, s["mi"],
                                          device_loop=False, **kw)
    err = np.linalg.norm(p1.numpy()[:, :, 3] - s["poses"][:, :, 3], axis=1)
    errh = np.linalg.norm(ph[:, :, 3] - s["poses"][:, :, 3], axis=1)
    assert err.max() < 0.08 and errh.max() < 0.08
    with pytest.raises(ValueError):
        TCEM.refine_pose_cem_batched(s["tr"], s["obs"], init, s["mi"],
                                     occluder_poses=init, device="cpu")
