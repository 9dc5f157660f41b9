"""Synthetic image sequences for the full camera pipeline.

Two generators:

- `render_blob_frames`: landmarks as gaussian blobs on a dark flat
  background (each blob center IS the projection of a fixed 3-D point
  along the trajectory) — the clean, easiest-possible tracking substrate.
- `render_adversarial_frames`: the same physically-consistent blobs under
  the stresses real VISMA footage has (the sequences are literally named
  clutter*/occlusion*, generate_all.sh:5-12): per-pixel sensor noise,
  a TEXTURED background (a distant sphere rendered by exact per-frame
  ray-sphere intersection, so background texture moves consistently with
  the camera — distractor features are geometrically valid but far),
  slow photometric gain/offset drift, and transient textured occluders
  sweeping through the field of view (they hide landmarks AND mint
  fast-moving distractor corners that the tracker's residual/FB gates and
  the filter's chi2 gate must reject).

bench.py runs the flagship throughput/ATE metric on the adversarial
generator; the gate parameters are justified by the
noise sweep in tools/noise_sweep.py (results in docs/NOISE_SWEEP.md).
"""
from __future__ import annotations

import numpy as np

from visma_tpu_torch.io.synthetic import (SyntheticConfig, make_landmarks,
                                    make_trajectory, project)


def _paint_blobs(img: np.ndarray, xp: np.ndarray, valid: np.ndarray,
                 amp: np.ndarray, sigma: float) -> None:
    """Add subpixel-positioned gaussian blobs to img in place."""
    H, W = img.shape
    yy, xx = np.mgrid[-4:5, -4:5].astype(np.float32)
    for j in np.nonzero(valid)[0]:
        u, v = xp[j]
        iu, iv = int(round(u)), int(round(v))
        du, dv = u - iu, v - iv
        if 5 <= iu < W - 5 and 5 <= iv < H - 5:
            k = np.exp(-(((xx - du) ** 2) + ((yy - dv) ** 2))
                       / (2 * sigma**2))
            img[iv - 4 : iv + 5, iu - 4 : iu + 5] += amp[j] * k


def render_blob_frames(cfg: SyntheticConfig, sigma: float = 2.0,
                       amplitude: float = 200.0, background: float = 20.0):
    """Returns (frames (N,H,W) float32, gwc (N,3,4), X (L,3))."""
    ts, gwc = make_trajectory(cfg)
    X = make_landmarks(cfg)
    H, W = cfg.rows, cfg.cols
    frames = np.full((cfg.num_frames, H, W), background, np.float32)

    rng = np.random.default_rng(cfg.seed + 9)
    # static per-landmark brightness so appearance is temporally stable
    amp = amplitude * rng.uniform(0.6, 1.0, size=len(X)).astype(np.float32)

    for i in range(cfg.num_frames):
        xp, depth, valid = project(gwc[i], X, cfg)
        _paint_blobs(frames[i], xp, valid, amp, sigma)
        np.clip(frames[i], 0, 255, out=frames[i])
    return frames, gwc, X


def _bg_texture(rng, size: int = 512, octaves: int = 4) -> np.ndarray:
    """Smooth multi-octave random texture in [-1, 1], wrap-periodic in the
    longitude axis (axis 1) so the sphere seam is invisible."""
    import cv2

    tex = np.zeros((size, size), np.float32)
    for o in range(octaves):
        n = 8 << o
        coarse = rng.standard_normal((n, n)).astype(np.float32)
        coarse = np.concatenate([coarse, coarse[:, :1]], axis=1)  # wrap u
        up = cv2.resize(coarse, (size + size // n, size),
                        interpolation=cv2.INTER_CUBIC)[:, :size]
        tex += up / (1.6 ** o)
    tex /= np.abs(tex).max() + 1e-6
    return tex


def _sphere_background(gwc: np.ndarray, cfg: SyntheticConfig,
                       tex: np.ndarray, bg_radius: float) -> np.ndarray:
    """Render the textured far sphere for one frame by exact per-pixel
    ray-sphere intersection (camera at gwc, sphere centered at the world
    origin) — background texture that moves EXACTLY as distant geometry
    should under the trajectory."""
    import cv2

    H, W = cfg.rows, cfg.cols
    R, t = gwc[:, :3], gwc[:, 3]
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    d_cam = np.stack([(u - cfg.cx) / cfg.fx, (v - cfg.cy) / cfg.fy,
                      np.ones_like(u)], axis=-1)
    d_w = d_cam @ R.T.astype(np.float32)                      # (H,W,3)
    d_w /= np.linalg.norm(d_w, axis=-1, keepdims=True)
    # |t + s d| = bg_radius, camera inside the sphere -> one positive root
    b = d_w @ t.astype(np.float32)
    c = float(t @ t) - bg_radius * bg_radius
    s = -b + np.sqrt(np.maximum(b * b - c, 0.0))
    p = t.astype(np.float32) + s[..., None] * d_w
    lon = np.arctan2(p[..., 1], p[..., 0])                    # [-pi, pi]
    lat = np.arcsin(np.clip(p[..., 2] / bg_radius, -1.0, 1.0))
    th, tw = tex.shape
    mu = ((lon / (2 * np.pi) + 0.5) * tw).astype(np.float32)
    mv = ((lat / np.pi + 0.5) * (th - 1)).astype(np.float32)
    return cv2.remap(tex, mu, mv, interpolation=cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_WRAP)


def render_adversarial_frames(cfg: SyntheticConfig, sigma: float = 2.0,
                              amplitude: float = 200.0,
                              background: float = 60.0,
                              bg_amplitude: float = 35.0,
                              bg_radius: float = 12.0,
                              noise_sigma: float = 2.0,
                              contrast_drift: float = 0.15,
                              offset_drift: float = 4.0,
                              occluders: int = 2,
                              occluder_size: tuple = (0.35, 0.22)):
    """Adversarial variant of render_blob_frames (see module docstring).

    occluders: number of occluder sweeps across the sequence; each lasts
    ~N/(2*occluders) frames, crossing the full image width.
    occluder_size: (height, width) as fractions of the image.
    Returns (frames (N,H,W) float32, gwc (N,3,4), X (L,3)).
    """
    ts, gwc = make_trajectory(cfg)
    X = make_landmarks(cfg)
    H, W = cfg.rows, cfg.cols
    N = cfg.num_frames
    rng = np.random.default_rng(cfg.seed + 9)
    amp = amplitude * rng.uniform(0.6, 1.0, size=len(X)).astype(np.float32)

    tex = _bg_texture(rng)
    oh, ow = int(H * occluder_size[0]), int(W * occluder_size[1])
    # texture sized to the occluder (a fixed 256x256 slice
    # underfills oh/ow for frames taller than ~731 px and the paint
    # assignment below then shape-mismatches)
    occ_size = max(256, 1 + (max(oh, ow) | 7))
    occ_tex = (background
               + bg_amplitude * 1.5 * _bg_texture(rng, size=occ_size,
                                                  octaves=5)
               )[:oh, :ow].astype(np.float32)
    # occluder sweep schedule: start frame and vertical center per sweep
    sweep_len = max(N // (2 * max(occluders, 1)), 4) if occluders else 0
    sweeps = [(int((k + 0.25) * N / occluders) - sweep_len // 2,
               rng.uniform(0.25, 0.75))
              for k in range(occluders)]

    frames = np.empty((N, H, W), np.float32)
    for i in range(N):
        img = background + bg_amplitude * _sphere_background(
            gwc[i], cfg, tex, bg_radius)
        xp, depth, valid = project(gwc[i], X, cfg)
        _paint_blobs(img, xp, valid, amp, sigma)

        for (f0, ycf) in sweeps:
            if f0 <= i < f0 + sweep_len:
                # crosses the full width over sweep_len frames
                frac = (i - f0) / max(sweep_len - 1, 1)
                xc = int(frac * (W + ow)) - ow // 2
                yc = int(ycf * H)
                x0, x1 = max(xc - ow // 2, 0), min(xc + ow - ow // 2, W)
                y0, y1 = max(yc - oh // 2, 0), min(yc + oh - oh // 2, H)
                if x1 > x0 and y1 > y0:
                    img[y0:y1, x0:x1] = occ_tex[: y1 - y0, : x1 - x0]

        # photometric drift: slow gain + offset oscillation over the run
        g = 1.0 + contrast_drift * np.sin(2 * np.pi * 1.5 * i / N)
        o = offset_drift * np.sin(2 * np.pi * 0.7 * i / N + 1.0)
        img = img * g + o
        img += rng.standard_normal((H, W)).astype(np.float32) * noise_sigma
        np.clip(img, 0, 255, out=img)
        frames[i] = img
    return frames, gwc, X
