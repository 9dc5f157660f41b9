# Frozen copy of visma_tpu_torch/filter/imu.py at 43be5d3; imports point into
# portbench.reference.vio. Part of the benchmark's plain reference.
"""Error-state IMU propagation (port of visma_tpu/filter/imu.py).

`_step` is the single-sample reference. `propagate` batches every
per-sample quantity like the reference (imu.py:79-161) but replaces its two
`lax.associative_scan`s, a TPU latency device, by sequential folds over the
S samples (S = 8 on the bench): the attitude prefix product and the
(Phi, Q) composition. The fold associates left to right, the reference's
scan as a tree, so the two agree to float32 association order only.

Transition and noise matrices are built out of place (`with_blocks`,
`diag_embed`), never by an indexed store into a fresh buffer, so that
`torch.func.vmap` can batch every function here over streams
(`Msckf.run_batched`).
"""
from __future__ import annotations

import torch

from portbench.reference.vio.config import FilterConfig
from portbench.reference.vio.state import FilterState
from portbench.reference.vio.rotations import hat, rodrigues
from portbench.reference.vio.misc import device_constant, with_blocks


@device_constant
def _gravity_vector(gravity: float, device: torch.device) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, -gravity], dtype=torch.float32,
                        device=device)


def _gravity(cfg: FilterConfig, device) -> torch.Tensor:
    """World gravity (0, 0, -g), made once per device."""
    return _gravity_vector(cfg.gravity, device)


def _eye(n: int, device) -> torch.Tensor:
    return torch.eye(n, dtype=torch.float32, device=device)


def _imu_transition(R, Ra, dt, D: int) -> torch.Tensor:
    """The (..., D, D) error-state transition of one IMU sample: identity
    but for the blocks of dp/dv, dv/dtheta, dv/dba and dtheta/dbg. R
    (..., 3, 3) the attitude before the sample, Ra (..., 3) the rotated
    specific force, dt broadcastable to (..., 1, 1)."""
    I3 = _eye(3, R.device)
    Rdt = R * dt
    return with_blocks(_eye(D, R.device), [
        (3, 6, I3 * dt), (6, 0, -hat(Ra) * dt), (6, 12, -Rdt), (0, 9, -Rdt)])


def _imu_noise(cfg: FilterConfig, dt, D: int) -> torch.Tensor:
    """The (..., D) diagonal of one sample's process noise for dt (..., 1):
    gyro, accel and the two bias walks on their 3-blocks, 0 elsewhere."""
    z = torch.zeros_like(dt)
    three = dt.shape[:-1] + (3,)
    q = [cfg.gyro_noise ** 2 * dt, z, cfg.accel_noise ** 2 * dt,
         cfg.gyro_bias_walk ** 2 * dt, cfg.accel_bias_walk ** 2 * dt]
    return torch.cat([x.expand(three) for x in q]
                     + [z.expand(dt.shape[:-1] + (D - 15,))], dim=-1)


def _step(cfg: FilterConfig, state: FilterState, gyro, accel, dt):
    """One IMU sample. dt may be 0 (masked sample), then it is a no-op."""
    dev = state.P.device
    w = gyro - state.bg
    a = accel - state.ba
    R = state.R
    Ra = R @ a
    a_w = Ra + _gravity(cfg, dev)

    dR = rodrigues(w * dt)
    R_new = R @ dR
    v_new = state.v + a_w * dt
    p_new = state.p + state.v * dt + 0.5 * a_w * dt * dt

    D = cfg.dim
    F = _imu_transition(R, Ra, dt, D)
    Q = torch.diag_embed(_imu_noise(cfg, dt.reshape(1), D))

    P_new = F @ state.P @ F.T + Q
    P_new = 0.5 * (P_new + P_new.T)
    return state.replace(R=R_new, p=p_new, v=v_new, P=P_new,
                         t=state.t + dt)


def propagate_cv(cfg: FilterConfig, state: FilterState,
                 dt: torch.Tensor) -> FilterState:
    """Vision-only process model: constant velocity and attitude, biases
    frozen (imu.py:58-76)."""
    dev = state.P.device
    D = cfg.dim
    p_new = state.p + state.v * dt
    F = with_blocks(_eye(D, dev), [(3, 6, _eye(3, dev) * dt)])
    z = torch.zeros_like(dt).expand(3)
    Q = torch.diag_embed(torch.cat([
        (cfg.cv_rot_noise ** 2 * dt).expand(3), z,
        (cfg.cv_vel_noise ** 2 * dt).expand(3),
        torch.zeros_like(dt).expand(D - 9)]))
    P_new = F @ state.P @ F.T + Q
    P_new = 0.5 * (P_new + P_new.T)
    return state.replace(p=p_new, P=P_new, t=state.t + dt)


def propagate(cfg: FilterConfig, state: FilterState, gyro: torch.Tensor,
              accel: torch.Tensor, dts: torch.Tensor) -> FilterState:
    """Propagate over a fixed-size IMU batch; masked samples carry dt == 0.

    gyro/accel (S, 3); dts (S,) with 0 for padding slots.
    """
    dev = state.P.device
    S = dts.shape[0]
    dt = dts[:, None]

    w = gyro - state.bg
    a = accel - state.ba
    dR = rodrigues(w * dt)                                # (S,3,3)

    # attitude prefix products (dt = 0 gives dR = I)
    cum = [dR[0]]
    for k in range(1, S):
        cum.append(cum[-1] @ dR[k])
    R_after = state.R @ torch.stack(cum)                  # (S,3,3)
    R_pre = torch.cat([state.R[None], R_after[:-1]], dim=0)

    Ra = torch.einsum("sij,sj->si", R_pre, a)
    a_w = Ra + _gravity(cfg, dev)
    dv = a_w * dt
    v_after = state.v + torch.cumsum(dv, dim=0)
    v_pre = v_after - dv
    p = state.p + torch.sum(v_pre * dt + 0.5 * a_w * dt * dt, dim=0)
    t = state.t + torch.sum(dts)

    # batched error-state transitions of the 15-dim IMU block
    F = _imu_transition(R_pre, Ra, dt[..., None], 15)     # (S,15,15)
    Qk = torch.diag_embed(_imu_noise(cfg, dt, 15))        # (S,15,15)

    # (Phi_b, Q_b) o (Phi_a, Q_a) = (Phi_b Phi_a, Phi_b Q_a Phi_b^T + Q_b)
    Phi, Q15 = F[0], Qk[0]
    for k in range(1, S):
        Phi, Q15 = F[k] @ Phi, F[k] @ Q15 @ F[k].T + Qk[k]

    P = state.P
    top = Phi @ P[:15, :]
    Pn = torch.cat([top, P[15:, :]], dim=0)
    left = Pn[:, :15] @ Phi.T
    Pn = torch.cat([left, Pn[:, 15:]], dim=1)
    Pn = torch.cat([torch.cat([Pn[:15, :15] + Q15, Pn[:15, 15:]], dim=1),
                    Pn[15:, :]], dim=0)
    Pn = 0.5 * (Pn + Pn.T)
    return state.replace(R=R_after[-1], p=p, v=v_after[-1], P=Pn, t=t)
