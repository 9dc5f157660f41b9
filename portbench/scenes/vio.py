"""VIO scenes made from a seed: the orbit, its IMU, the landmarks, the
adversarial camera frames as the Corvis camera delivers them (raw,
distorted, uint8), and recorded feature feeds.

Frozen rewrites, at 43be5d3, of visma_tpu_torch/io/synthetic.py
(`make_trajectory`, `make_landmarks`, `project`, `make_imu`),
visma_tpu_torch/io/synthetic_images.py (`render_adversarial_frames`: blobs
on a textured far sphere, sensor noise, photometric drift, occluder
sweeps), chip_smoke.py's `inverse_atan_table` and `warp_to_raw`, and
visma_tpu_torch/filter/feed.py's packing. The frames are made on the
device, in a few large calls; the orbit and its IMU are a few thousand
float64 numbers and are made on the host.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.vio.undistort import bilinear_remap_plain


def sub_seed(seed: int, k: int) -> int:
    """A seed of its own for item k of a run seeded with `seed`."""
    return int(np.random.SeedSequence([int(seed) & (2 ** 63 - 1), k])
               .generate_state(1, dtype=np.uint64)[0] >> 1)


def _look_at(eye: np.ndarray) -> np.ndarray:
    """(n, 3, 3) camera-to-world rotations looking at the origin, +z
    forward, world z up."""
    z = -eye / np.linalg.norm(eye, axis=-1, keepdims=True)
    x = np.cross(z, np.array([0.0, 0.0, 1.0]))
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=-1)


def _log_so3(R: np.ndarray) -> np.ndarray:
    """Rotation vectors of (n, 3, 3) rotations well below pi."""
    c = np.clip((np.trace(R, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(c)
    v = np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                  R[:, 1, 0] - R[:, 0, 1]], axis=-1)
    s = np.sin(th)
    f = np.where(th < 1e-8, 0.5, th / (2.0 * np.where(th < 1e-8, 1.0, s)))
    return v * f[:, None]


def orbit(scene: dict, n_frames: int, phase: float) -> dict:
    """The camera's orbit around the scene and the IMU that integrates
    exactly onto it (make_imu's discrete-consistent construction), with
    `samples_per_frame` samples between frames.

    Returns {R (n, 3, 3), p (n, 3) frame poses camera-to-world, gyro,
    accel ((n - 1) * spf, 3), v0 (3,), dt}, float64."""
    spf = scene["imu_samples_per_frame"]
    dt = 1.0 / (scene["fps"] * spf)
    S = (n_frames - 1) * spf + 1
    ts = np.arange(S) * dt
    r, w, h = scene["orbit_radius"], scene["orbit_rate"], scene["orbit_height"]
    th = w * ts + phase
    pos = np.stack([r * np.cos(th), r * np.sin(th),
                    h + 0.1 * np.sin(2.3 * th)], axis=1)
    vel0 = np.array([-r * w * np.sin(phase), r * w * np.cos(phase),
                     0.1 * 2.3 * w * np.cos(phase)])
    Rs = _look_at(pos)
    gyro = _log_so3(np.einsum("nji,njk->nik", Rs[:-1], Rs[1:])) / dt
    g_world = np.array([0.0, 0.0, -scene["gravity"]])
    accel = np.zeros((S - 1, 3))
    v = vel0.copy()
    for i in range(S - 1):
        a_w = 2.0 * (pos[i + 1] - pos[i] - v * dt) / (dt * dt)
        accel[i] = Rs[i].T @ (a_w - g_world)
        v = v + a_w * dt
    return {"R": Rs[::spf], "p": pos[::spf], "gyro": gyro, "accel": accel,
            "v0": vel0, "dt": dt}


def landmarks(scene: dict, rng: np.random.Generator) -> np.ndarray:
    n = scene["num_landmarks"]
    pts = rng.uniform(-1.0, 1.0, size=(n, 3))
    pts[:, 2] = rng.uniform(0.0, 2.0, size=n)
    return pts


def project(R, p, X, K, rows: int, cols: int):
    """Pinhole projection of landmarks X (L, 3) into frames (n, 3, 3),
    (n, 3): (xp (n, L, 2), valid (n, L)), float64 tensors on X's device."""
    Xc = torch.einsum("nji,nlj->nli", R, X[None] - p[:, None])
    z = Xc[..., 2]
    valid = z > 0.1
    zs = torch.where(valid, z, torch.ones_like(z))
    u = K[0][0] * Xc[..., 0] / zs + K[0][2]
    v = K[1][1] * Xc[..., 1] / zs + K[1][2]
    valid &= (u >= 0) & (u < cols) & (v >= 0) & (v < rows)
    return torch.stack([u, v], dim=-1), valid


def _texture(gen, size: int, octaves: int, device) -> torch.Tensor:
    """Smooth multi-octave random texture in [-1, 1], periodic along its
    columns."""
    tex = torch.zeros((size, size), dtype=torch.float32, device=device)
    for o in range(octaves):
        n = 8 << o
        coarse = torch.randn((n, n), generator=gen, device=device)
        coarse = torch.cat([coarse, coarse[:, :1]], dim=1)
        up = F.interpolate(coarse[None, None], size=(size, size + size // n),
                           mode="bicubic", align_corners=False)[0, 0]
        tex += up[:, :size] / (1.6 ** o)
    return tex / (tex.abs().max() + 1e-6)


def _sphere(R, p, K, rows, cols, tex, radius):
    """The textured far sphere seen from frames (n, 3, 3), (n, 3): exact
    per-pixel ray-sphere intersection, the texture sampled bilinearly with
    the longitude wrapping. (n, rows, cols) float32."""
    dev = tex.device
    v, u = torch.meshgrid(torch.arange(rows, dtype=torch.float32, device=dev),
                          torch.arange(cols, dtype=torch.float32, device=dev),
                          indexing="ij")
    d_cam = torch.stack([(u - K[0][2]) / K[0][0], (v - K[1][2]) / K[1][1],
                         torch.ones_like(u)], dim=-1)
    Rf, pf = R.to(torch.float32), p.to(torch.float32)
    d_w = torch.einsum("hwj,nij->nhwi", d_cam, Rf)
    d_w = d_w / torch.linalg.vector_norm(d_w, dim=-1, keepdim=True)
    b = torch.einsum("nhwi,ni->nhw", d_w, pf)
    c = (pf * pf).sum(-1)[:, None, None] - radius * radius
    s = -b + torch.sqrt(torch.clamp(b * b - c, min=0.0))
    q = pf[:, None, None] + s[..., None] * d_w
    lon = torch.atan2(q[..., 1], q[..., 0])
    lat = torch.asin(torch.clamp(q[..., 2] / radius, -1.0, 1.0))
    th, tw = tex.shape
    mu = (lon / (2 * math.pi) + 0.5) * tw
    mv = (lat / math.pi + 0.5) * (th - 1)
    x0 = torch.floor(mu)
    y0 = torch.clamp(torch.floor(mv), 0, th - 2)
    fx, fy = mu - x0, mv - y0
    xi0 = torch.remainder(x0.long(), tw)
    xi1 = torch.remainder(xi0 + 1, tw)
    yi = y0.long()
    t00, t01 = tex[yi, xi0], tex[yi, xi1]
    t10, t11 = tex[yi + 1, xi0], tex[yi + 1, xi1]
    return ((1 - fy) * ((1 - fx) * t00 + fx * t01)
            + fy * ((1 - fx) * t10 + fx * t11))


def _paint_blobs(img, xp, valid, amp, sigma: float):
    """Add 9x9 gaussian blobs at the landmarks' pixels (n, L, 2) into
    frames (n, H, W) in place, where the blob lies inside the frame. One
    landmark at a time over all frames, so that no two additions meet in
    one call and the sums come out the same on every run."""
    n, H, W = img.shape
    iu = torch.round(xp[..., 0]).long()
    iv = torch.round(xp[..., 1]).long()
    du = (xp[..., 0] - iu).to(torch.float32)
    dv = (xp[..., 1] - iv).to(torch.float32)
    ok = valid & (iu >= 5) & (iu < W - 5) & (iv >= 5) & (iv < H - 5)
    off = torch.arange(-4, 5, device=img.device)
    k = torch.exp(-(((off[None, None, None, :] - du[..., None, None]) ** 2)
                    + ((off[None, None, :, None] - dv[..., None, None]) ** 2))
                  / (2 * sigma ** 2)) * amp[None, :, None, None]
    k = k * ok[..., None, None]
    fi = torch.arange(n, device=img.device)[:, None, None].expand(n, 9, 9)
    rr = torch.clamp(iv[..., None, None] + off[:, None], 0, H - 1)
    cc = torch.clamp(iu[..., None, None] + off[None, :], 0, W - 1)
    for j in range(xp.shape[1]):
        img.index_put_((fi, rr[:, j].expand(n, 9, 9),
                        cc[:, j].expand(n, 9, 9)), k[:, j], accumulate=True)


def inverse_atan_table(calib: dict, K_out: np.ndarray) -> np.ndarray:
    """For every raw (distorted) pixel, the (x, y) of the undistorted
    output frame that it shows, clamped to that frame: (in_rows, in_cols,
    2) float32."""
    fx = calib["fx"] * calib["in_cols"]
    fy = calib["fy"] * calib["in_rows"]
    cx = calib["cx"] * calib["in_cols"] - 0.5
    cy = calib["cy"] * calib["in_rows"] - 0.5
    s = calib["s"]
    yd, xd = np.mgrid[0:calib["in_rows"], 0:calib["in_cols"]].astype(
        np.float64)
    mx, my = (xd - cx) / fx, (yd - cy) / fy
    rd = np.sqrt(mx * mx + my * my)
    safe = np.where(rd == 0, 1.0, rd)
    fac = np.where(rd == 0, 1.0,
                   np.tan(safe * s) / (2.0 * np.tan(s / 2.0)) / safe)
    u = np.clip(K_out[0, 0] * mx * fac + K_out[0, 2], 0.0,
                calib["out_cols"] - 1.0)
    v = np.clip(K_out[1, 1] * my * fac + K_out[1, 2], 0.0,
                calib["out_rows"] - 1.0)
    return np.stack([u, v], axis=-1).astype(np.float32)


def raw_sequence(scene: dict, calib: dict, K_out: np.ndarray,
                 inv_table: torch.Tensor, seed: int, n_frames: int,
                 chunk: int = 24) -> Dict[str, object]:
    """One adversarial sequence as the Corvis camera records it: frames
    rendered in the undistorted output camera K_out (out_rows x out_cols),
    warped to the raw distorted frame and quantised to uint8 on the device.

    Returns {raw (n, in_rows, in_cols) uint8 on the device, and the orbit's
    R, p, gyro, accel, v0, dt (float64 numpy)}."""
    dev = inv_table.device
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    traj = orbit(scene, n_frames, float(rng.uniform(0.0, 2.0 * math.pi)))
    X = torch.as_tensor(landmarks(scene, rng), device=dev)
    H, W = calib["out_rows"], calib["out_cols"]
    N = n_frames
    img_cfg = scene["images"]
    amp = img_cfg["blob_amplitude"] * (
        0.6 + 0.4 * torch.rand(X.shape[0], generator=gen, device=dev))
    tex = _texture(gen, 512, 4, dev)
    oh = int(H * img_cfg["occluder_size"][0])
    ow = int(W * img_cfg["occluder_size"][1])
    occ_size = max(256, 1 + (max(oh, ow) | 7))
    occ_tex = (img_cfg["background"] + img_cfg["bg_amplitude"] * 1.5
               * _texture(gen, occ_size, 5, dev))[:oh, :ow]
    n_occ = img_cfg["occluders"]
    sweep_len = max(N // (2 * n_occ), 4)
    sweeps = [(int((k + 0.25) * N / n_occ) - sweep_len // 2,
               float(rng.uniform(0.25, 0.75))) for k in range(n_occ)]
    Kt = [[float(v) for v in row] for row in K_out]
    Rd = torch.as_tensor(traj["R"], device=dev)
    pd = torch.as_tensor(traj["p"], device=dev)
    raw = torch.empty((N, calib["in_rows"], calib["in_cols"]),
                      dtype=torch.uint8, device=dev)
    for a in range(0, N, chunk):
        b = min(a + chunk, N)
        img = img_cfg["background"] + img_cfg["bg_amplitude"] * _sphere(
            Rd[a:b], pd[a:b], Kt, H, W, tex, img_cfg["bg_radius"])
        xp, valid = project(Rd[a:b], pd[a:b], X, Kt, H, W)
        _paint_blobs(img, xp, valid, amp, img_cfg["blob_sigma"])
        for i in range(a, b):
            for f0, ycf in sweeps:
                if not f0 <= i < f0 + sweep_len:
                    continue
                frac = (i - f0) / max(sweep_len - 1, 1)
                xc = int(frac * (W + ow)) - ow // 2
                yc = int(ycf * H)
                x0, x1 = max(xc - ow // 2, 0), min(xc + ow - ow // 2, W)
                y0, y1 = max(yc - oh // 2, 0), min(yc + oh - oh // 2, H)
                if x1 > x0 and y1 > y0:
                    img[i - a, y0:y1, x0:x1] = occ_tex[:y1 - y0, :x1 - x0]
        i = torch.arange(a, b, device=dev, dtype=torch.float32)[:, None, None]
        g = 1.0 + img_cfg["contrast_drift"] * torch.sin(2 * math.pi * 1.5 * i
                                                        / N)
        o = img_cfg["offset_drift"] * torch.sin(2 * math.pi * 0.7 * i / N
                                                + 1.0)
        img = img * g + o
        img += torch.randn(img.shape, generator=gen, device=dev) \
            * img_cfg["noise_sigma"]
        img = torch.clamp(img, 0, 255)
        warped = bilinear_remap_plain(img, inv_table)
        raw[a:b] = torch.clamp(torch.round(warped), 0, 255).to(torch.uint8)
    out = dict(traj)
    out["raw"] = raw
    return out


def imu_frames(traj: dict, device) -> Dict[str, torch.Tensor]:
    """The IMU of frames 1..n-1 as the filter takes it: gyro, accel (n-1,
    spf, 3) and dts (n-1, spf), float32 on the device."""
    n = traj["R"].shape[0] - 1
    g = torch.as_tensor(traj["gyro"], dtype=torch.float32, device=device)
    a = torch.as_tensor(traj["accel"], dtype=torch.float32, device=device)
    spf = g.shape[0] // n
    return {"gyro": g.reshape(n, spf, 3), "accel": a.reshape(n, spf, 3),
            "dts": torch.full((n, spf), traj["dt"], dtype=torch.float32,
                              device=device)}


def feature_feeds(scene: dict, K: np.ndarray, rows: int, cols: int,
                  seed: int, streams: int, n_frames: int, max_feats: int,
                  device) -> Dict[str, torch.Tensor]:
    """Recorded tracklets of `streams` cameras, each over its own landmarks
    along one shared orbit: per frame the first `max_feats` visible
    landmarks by id, their pixels with `pixel_noise` px of gaussian noise,
    and the IMU between frames (frame 0 has none), as feed.pack_frames
    lays them out. Returns {gyro, accel (B, n, spf, 3), dts (B, n, spf),
    ids (B, n, F) int32, xp (B, n, F, 2), valid (B, n, F)} on the device
    and the orbit's R, p, v0 (float64 numpy)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    traj = orbit(scene, n_frames, float(rng.uniform(0.0, 2.0 * math.pi)))
    X = torch.as_tensor(np.stack([landmarks(scene, rng)
                                  for _ in range(streams)]), device=device)
    Rd = torch.as_tensor(traj["R"], device=device)
    pd = torch.as_tensor(traj["p"], device=device)
    Kt = [[float(v) for v in row] for row in K]
    xp, valid = zip(*(project(Rd, pd, X[b], Kt, rows, cols)
                      for b in range(streams)))
    xp, valid = torch.stack(xp), torch.stack(valid)        # (B, n, L, ...)
    xp = xp + scene["feeds"]["pixel_noise"] * torch.randn(
        xp.shape, generator=gen, device=device, dtype=xp.dtype)
    rank = torch.cumsum(valid.to(torch.int64), dim=-1) - 1
    keep = valid & (rank < max_feats)
    B, n, L = valid.shape
    slot = torch.where(keep, rank, torch.full_like(rank, max_feats))
    ids = torch.full((B, n, max_feats + 1), -1, dtype=torch.int32,
                     device=device)
    lm = torch.arange(L, dtype=torch.int32, device=device).expand(B, n, L)
    ids = ids.scatter(2, slot, torch.where(keep, lm, torch.full_like(lm, -1)))
    pix = torch.zeros((B, n, max_feats + 1, 2), dtype=torch.float32,
                      device=device)
    pix = pix.scatter(2, slot[..., None].expand(B, n, L, 2),
                      xp.to(torch.float32))
    ids, pix = ids[..., :max_feats], pix[..., :max_feats]
    imu = imu_frames(traj, device)
    frames = {}
    for k, v in imu.items():
        v = torch.cat([torch.zeros_like(v[:1]), v])          # frame 0: none
        frames[k] = v[None].expand(B, *v.shape).contiguous()
    frames.update({"ids": ids.contiguous(), "xp": pix.contiguous(),
                   "valid": (ids >= 0).contiguous()})
    return {"frames": frames, "R": traj["R"], "p": traj["p"],
            "v0": traj["v0"]}
