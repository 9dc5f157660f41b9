"""A detection's shape retrieval, plainly: every (model, yaw) hypothesis
rendered in one window at the detection and scored against the frame's
edge evidence; the least score, with the box's aspect and the detector's
azimuth prior added, picks the model and its start pose.

Frozen copies, at 4de2067, of visma_tpu_torch/semantic/mapper.py
(`SemanticMapper._init_pose_cm`, the window branch of
`SemanticMapper.retrieve_shape`, `SemanticMapper._covered`) and of
visma_tpu_torch/semantic/cem.py's `_retrieval_scores`, over the
reference's rasterizer and edge score. Float32 on the device, float64 on
the host, as the program. A detection is anything with the attributes of
the program's `BoundingBox` (top_left_x, top_left_y, bottom_right_x,
bottom_right_y, class_name, shape_id, azimuth_prob). Part of the
benchmark's plain reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference.semantic.cem import (_aabb_corners, _crop,
                                              occlusion_aware_edge_score)
from portbench.reference.semantic.raster import render_roi


@dataclass
class Retrieval:
    """The pick: the model, its start pose and its score."""
    name: str
    pose_cm: np.ndarray          # (4, 4) model -> camera
    score: float


def init_translation(bbox, intr, aabb, depth_prior: float = 2.0
                     ) -> np.ndarray:
    """`_init_pose_cm`'s translation: the model's AABB centre on the
    detection's centre ray, at the depth the box's height gives the model
    (aabb None: the depth prior), less that centre."""
    cx = 0.5 * (bbox.top_left_x + bbox.bottom_right_x)
    cy = 0.5 * (bbox.top_left_y + bbox.bottom_right_y)
    h_px = abs(bbox.bottom_right_y - bbox.top_left_y)
    z = depth_prior
    c0 = np.zeros(3)
    if aabb is not None and h_px > 4:
        lo, hi = aabb
        c0 = 0.5 * (np.asarray(lo) + hi)
        z = float(np.clip(intr.fy * (hi[1] - lo[1]) / h_px,
                          0.3, 0.9 * intr.z_far))
        corners = _aabb_corners(lo, hi) - c0
        for _ in range(3):
            c = corners + [(cx - intr.cx) / intr.fx * z,
                           (cy - intr.cy) / intr.fy * z, z]
            zc = np.maximum(c[:, 2], 0.1)
            v = intr.fy * c[:, 1] / zc + intr.cy
            h_proj = v.max() - v.min()
            z = float(np.clip(z * h_proj / h_px, 0.3, 0.9 * intr.z_far))
    X_cam = np.array([(cx - intr.cx) / intr.fx * z,
                      (cy - intr.cy) / intr.fy * z, z])
    return X_cam - c0


def retrieve(bbox, edge_map: torch.Tensor, dt: torch.Tensor, Cs, names,
             aabbs: dict, intr, roi, yaws: int,
             prior_weight: float = 1.0,
             depth_prior: float = 2.0) -> Retrieval:
    """The retrieval of one detection in a (roi) window. names: the
    database in the renderer's order (indices of Cs); aabbs: {name: (lo,
    hi)}; dt: the distance transform of edge_map (default sweeps)."""
    cls = (bbox.class_name or "").lower()
    cands = [n for n in names if cls and cls in n.lower()] or list(names)
    B = yaws
    ang = np.arange(B) * (2 * np.pi / B)
    cs, sn = np.cos(ang), np.sin(ang)
    Ry = np.zeros((B, 3, 3))
    Ry[:, 0, 0] = cs
    Ry[:, 0, 2] = sn
    Ry[:, 2, 0] = -sn
    Ry[:, 2, 2] = cs
    Ry[:, 1, 1] = 1.0
    hyp_list = []
    boxes = [aabbs.get(c, (np.full(3, -0.5), np.full(3, 0.5)))
             for c in cands]
    for c, (lo, hi) in zip(cands, boxes):
        c0 = 0.5 * (np.asarray(lo) + hi)
        X_cam = init_translation(bbox, intr, aabbs.get(c), depth_prior) + c0
        h = np.broadcast_to(np.eye(3, 4), (B, 3, 4)).copy()
        h[:, :3, :3] = Ry
        h[:, :3, 3] = X_cam[None] - Ry @ c0
        hyp_list.append(h)
    hyps = np.concatenate(hyp_list)

    bb_w = max(abs(bbox.bottom_right_x - bbox.top_left_x), 1e-6)
    bb_h = max(abs(bbox.bottom_right_y - bbox.top_left_y), 1e-6)
    aspect_pen = np.zeros((len(cands), B), np.float32)
    for ci, (lo, hi) in enumerate(boxes):
        corners = _aabb_corners(lo, hi)
        for bi in range(B):
            P = hyp_list[ci][bi]
            pc = corners @ P[:, :3].T + P[:, 3]
            zc = np.maximum(pc[:, 2], 0.1)
            u = intr.fx * pc[:, 0] / zc
            v = intr.fy * pc[:, 1] / zc
            asp = (u.max() - u.min()) / max(v.max() - v.min(), 1e-6)
            aspect_pen[ci, bi] = 2.0 * abs(
                np.log(max(asp, 1e-6) / (bb_w / bb_h)))

    prior = np.zeros(B, np.float32)
    ap = np.asarray(bbox.azimuth_prob, np.float32).ravel()
    if ap.size > 0 and prior_weight > 0:
        p = ap / max(float(ap.sum()), 1e-6)
        bins = np.minimum((ang / (2 * np.pi) * ap.size).astype(int),
                          ap.size - 1)
        prior = -prior_weight * np.log(p[bins] + 1e-3)

    dev = edge_map.device
    H, W = intr.rows, intr.cols
    mx = 0.2 * (bbox.bottom_right_x - bbox.top_left_x)
    my = 0.2 * (bbox.bottom_right_y - bbox.top_left_y)
    x0 = int(np.clip(bbox.top_left_x - mx, 0, W))
    x1 = int(np.clip(bbox.bottom_right_x + mx, 0, W))
    y0 = int(np.clip(bbox.top_left_y - my, 0, H))
    y1 = int(np.clip(bbox.bottom_right_y + my, 0, H))
    idxs = np.array([list(names).index(n) for n in cands], np.int64)
    Hr, Wr = roi
    cx = 0.5 * (bbox.top_left_x + bbox.bottom_right_x)
    cy = 0.5 * (bbox.top_left_y + bbox.bottom_right_y)
    ox = float(np.clip(round(cx - Wr / 2), 0, W - Wr))
    oy = float(np.clip(round(cy - Hr / 2), 0, H - Hr))
    scores = window_scores(
        Cs, intr, roi, torch.as_tensor(hyps, dtype=torch.float32, device=dev),
        torch.as_tensor(np.repeat(idxs, B), device=dev),
        torch.tensor([ox, oy], dtype=torch.float32, device=dev), dt,
        edge_map, torch.tensor([x0, y0, x1, y1], dtype=torch.float32,
                               device=dev))
    scores = scores.cpu().numpy().reshape(len(cands), B) \
        + prior[None, :] + aspect_pen
    m, b = np.unravel_index(int(np.argmin(scores)), scores.shape)
    T = np.eye(4)
    T[:3, :4] = hyps[m * B + b]
    return Retrieval(cands[m], T, float(scores[m, b]))


def window_scores(Cs, intr, roi, hyps, mi, org1, dt, em, box):
    """(B,) edge scores of the hypotheses rendered in one window at org1
    (x0, y0), coverage counted inside box = (x0, y0, x1, y1)."""
    B = hyps.shape[0]
    origins = org1[None].expand(B, 2)
    d = render_roi(Cs, hyps, mi, origins, intr, roi)
    dt_w = _crop(dt, org1[None], roi)[0]
    em_w = _crop(em, org1[None], roi)[0]
    dev = hyps.device
    yy = org1[1] + torch.arange(roi[0], dtype=torch.float32,
                                device=dev)[:, None]
    xx = org1[0] + torch.arange(roi[1], dtype=torch.float32,
                                device=dev)[None, :]
    in_box = ((xx >= box[0]) & (xx < box[2])
              & (yy >= box[1]) & (yy < box[3]))
    return occlusion_aware_edge_score(
        d, None, dt_w, torch.where(in_box, em_w, torch.zeros_like(em_w)))


def covered(bbox, gwc: np.ndarray, tracks, aabbs: dict, intr,
            iou_thresh: float = 0.5) -> bool:
    """Does a track explain the detection: the IoU of the box and a
    track's projected AABB rectangle above `iou_thresh`. tracks: (model
    name, (4, 4) model -> world pose)."""
    bx0, bx1 = sorted((bbox.top_left_x, bbox.bottom_right_x))
    by0, by1 = sorted((bbox.top_left_y, bbox.bottom_right_y))
    b_area = max(bx1 - bx0, 0.0) * max(by1 - by0, 0.0)
    if b_area <= 0:
        return True
    G = np.eye(4)
    G[:3, :4] = gwc
    G_cw = np.linalg.inv(G)
    for name, pose_wm in tracks:
        lo, hi = aabbs.get(name, (np.full(3, -0.5), np.full(3, 0.5)))
        P = G_cw @ pose_wm
        pc = _aabb_corners(lo, hi) @ P[:3, :3].T + P[:3, 3]
        z = pc[:, 2]
        if np.any(z <= 0.1):
            continue
        u = intr.fx * pc[:, 0] / z + intr.cx
        v = intr.fy * pc[:, 1] / z + intr.cy
        ix0, ix1 = max(u.min(), bx0), min(u.max(), bx1)
        iy0, iy1 = max(v.min(), by0), min(v.max(), by1)
        inter = max(ix1 - ix0, 0.0) * max(iy1 - iy0, 0.0)
        t_area = (u.max() - u.min()) * (v.max() - v.min())
        union = max(b_area + t_area - inter, 1e-6)
        if inter / union > iou_thresh:
            return True
    return False
