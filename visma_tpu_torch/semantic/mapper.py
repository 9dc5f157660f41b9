"""Semantic mapper: per-object pose tracks from detections + edge evidence
(port of visma_tpu/semantic/mapper.py).

Workflow per frame (the papers' object-level mapping loop):
  1. new detections (BoundingBoxList with shape_id) spawn object tracks,
     initialized by back-projecting the bbox center at a depth estimate
     and, where the model is unknown, by retrieving the CAD shape over a
     yaw sweep;
  2. existing tracks refine their pose against the frame's edge map with
     CEM over batched render + score, all tracks jointly
     (render.raster.MultiMeshRenderer over the padded mesh stack), so the
     per-frame launch count does not grow with the number of objects;
  3. tracks export as reference-compatible result.json packets
     (model_pose is model->WORLD, composed through the frame's gwc).

Occlusion handling: each track's hypotheses score against the joint
z-buffer of the OTHER tracks at their poses at the START of the frame.

Host and device: detection handling, spawning and the footprint tests are
host arithmetic in numpy; render, score and refit run on the device. Once
all tracks are settled, the poses stay on the device from frame to frame
(see `async_frames`): a settled step enqueues its work and reads nothing
back.

Compiled run: on a CUDA device the CEM of a frame, a detection's
retrieval and the full-frame occluder render each replay one captured
CUDA graph (`cem.fused_cem_executor`, `cem.retrieval_executor`,
`exclusive_min_executor`: the reference's jitted executors), captured by
`warmup` or on the first call of a new shape; `graph=False` runs them
eagerly.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from visma_tpu_torch.render.camera import Intrinsics
from visma_tpu_torch.render.likelihood import (edge_distance_transform,
                                               occlusion_aware_edge_score)
from visma_tpu_torch.render.raster import (EXECUTOR_CACHES,
                                           MultiMeshRenderer,
                                           rasterize_depth_chunked_multi)
from visma_tpu_torch.semantic.cem import (CEM_TAU, _cem_run, _sigma6,
                                          cem_n_elite,
                                          refine_pose_cem_batched,
                                          retrieval_executor,
                                          retrieval_scores)
from visma_tpu_torch.utils.graphs import CallGraph, wants_graph
from visma_tpu_torch.utils.misc import resolve_device


@dataclass
class ObjectTrack:
    oid: int
    model_name: str
    pose_wm: np.ndarray              # (4,4) model -> world
    score: float = np.inf
    age: int = 0
    status: int = 2                  # reference result.json status int


def _aabb_corners(lo, hi) -> np.ndarray:
    return np.array([[x, y, z] for x in (lo[0], hi[0])
                     for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])


class SemanticMapper:
    def __init__(self, intr: Intrinsics, mesh_db: Dict[str, tuple],
                 depth_prior: float = 2.0, cem_iters: int = 5,
                 cem_samples: int = 48, retrieval_yaws: int = 12,
                 azimuth_prior_weight: float = 1.0,
                 roi: Optional[tuple] = None,
                 init_sigma: tuple = (0.15, 0.08),
                 settle_age: int = 2,
                 settled_iters: Optional[int] = None,
                 settled_samples: Optional[int] = None,
                 settled_sigma: Optional[tuple] = None,
                 async_frames: int = 0,
                 coverage_radius: int = 2,
                 roi_spawn: bool = False,
                 device=None, graph: Optional[bool] = None):
        """mesh_db: model_name -> (V, F). device: where render, score and
        refit run; None means the CUDA card, and raises without one.
        graph: None replays the executors' CUDA graphs on a CUDA device
        and runs eagerly on the CPU; True or False asks for the executors
        (on the CPU their buffers, without capture) or the eager functions
        (`utils.graphs.wants_graph`).

        retrieval_yaws / azimuth_prior_weight control detection-driven
        shape retrieval (see retrieve_shape). roi: optional (Hr, Wr)
        screen window for CEM render + score of SETTLED tracks (age >= 1;
        fresh spawns refine full-frame since their init error can exceed
        the window margin): per-hypothesis cost drops from rows*cols to
        Hr*Wr pixels, exact while footprints stay inside the window.

        Annealed settled schedule: once every track has age >=
        settle_age, the per-frame CEM switches to settled_iters x
        settled_samples at settled_sigma (rot rad, trans m): a settled
        track only corrects the residual drift since last frame. Leave
        the settled_* parameters None to disable annealing.

        coverage_radius: dilation radius (px) of the edge score's coverage
        term; the score is flat over about that much silhouette slack.

        roi_spawn: refine fresh spawns in the ROI window too. Safe when
        spawns come from detections with depth-from-height init (error
        well inside the window margin); the spawn frame then rasters
        several times fewer pixels.

        async_frames > 0 enables a device-resident steady state: once all
        tracks are settled (ROI mode, no new detections), track poses
        stay on the device, each frame enqueues one fused CEM without
        waiting for the previous one, and the host mirror
        (ObjectTrack.pose_wm / score / result packets) refreshes every
        `async_frames` frames or at finalize(). Call finalize()
        (write_result_json does) before reading poses."""
        self.intr = intr
        self.device = resolve_device(device)
        self.graphed = wants_graph(graph, self.device)
        self.mesh_db = mesh_db
        self.depth_prior = depth_prior
        self.cem_iters = cem_iters
        self.cem_samples = cem_samples
        self.retrieval_yaws = retrieval_yaws
        self.azimuth_prior_weight = azimuth_prior_weight
        self.roi = None if roi is None else (int(roi[0]), int(roi[1]))
        self.init_sigma = (float(init_sigma[0]), float(init_sigma[1]))
        self.settle_age = int(settle_age)
        self.settled_iters = settled_iters
        self.settled_samples = settled_samples
        self.settled_sigma = (None if settled_sigma is None else
                              (float(settled_sigma[0]),
                               float(settled_sigma[1])))
        self.coverage_radius = int(coverage_radius)
        self.roi_spawn = bool(roi_spawn)
        self.tracks: Dict[int, ObjectTrack] = {}
        self.mrenderer = MultiMeshRenderer(intr, device=self.device)
        self._mesh_aabb: Dict[str, tuple] = {}
        if mesh_db:
            self.mrenderer.set_meshes(mesh_db)
            self._mesh_aabb = {
                n: (np.asarray(V, np.float64).min(0),
                    np.asarray(V, np.float64).max(0))
                for n, (V, _) in mesh_db.items()}
        self._next_id = 0
        self.history: List = []
        self.async_frames = int(async_frames)
        self._dev: Optional[dict] = None   # device-resident track state
        self._frame_no = 0
        self._pinned: Optional[torch.Tensor] = None
        self._gen: Optional[torch.Generator] = None   # the async steps'

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _stage(self, dG: np.ndarray) -> torch.Tensor:
        """A (3,4) host matrix onto the device without making the host
        wait: on a CUDA device through a ring of pinned slots, copied
        asynchronously. A slot is reused after async_frames + 2 frames, by
        when a _sync_dev has waited for the copy out of it."""
        if self.device.type != "cuda":
            return self._f32(dG)
        if self._pinned is None:
            self._pinned = torch.empty((self.async_frames + 2, 3, 4),
                                       dtype=torch.float32, pin_memory=True)
        slot = self._pinned[self._frame_no % self._pinned.shape[0]]
        slot.copy_(torch.from_numpy(dG))
        return slot.to(self.device, non_blocking=True)

    def warmup(self, n_objects: int) -> float:
        """Build and load the kernels and make every executor of an
        `n_objects` scene ready, as the reference's warmup compiles them
        (visma_tpu/semantic/mapper.py:132-197): the CEM of both schedules
        in the window with occluders rendered from poses, and, in the
        window, the retrieval of one detection over the whole database x
        retrieval_yaws. Graphed (see `graph`), each executor runs its
        eager warm-up calls and is captured, so the first real frames
        replay; eagerly, each runs once on an empty edge map. Returns
        elapsed seconds; `captures` and `capture_ms` say what was
        captured."""
        t0 = time.time()
        n = int(n_objects)
        if self.device.type == "cuda":
            from visma_tpu_torch import _kernels

            _kernels.library()
        if not self.mesh_db or n < 1:
            return time.time() - t0
        calls = CallGraph.warmup + 1 if self.graphed else 1
        poses = np.tile(np.eye(4, dtype=np.float32)[None, :3], (n, 1, 1))
        poses[:, 2, 3] = self.depth_prior
        poses[:, 0, 3] = 0.1 * np.arange(n)
        edge = torch.zeros((self.intr.rows, self.intr.cols),
                           dtype=torch.float32, device=self.device)
        scheds = [(self.cem_iters, self.cem_samples, self.init_sigma)]
        if self.settled_iters and self.settled_samples:
            scheds.append((self.settled_iters, self.settled_samples,
                           self.settled_sigma or self.init_sigma))
        for iters, samples, sigma in scheds:
            for _ in range(calls):
                refine_pose_cem_batched(
                    self.mrenderer, edge, poses, np.zeros(n, np.int32),
                    iters=iters, samples=samples, init_sigma=sigma,
                    roi=self.roi,
                    occluder_poses=poses if self.roi is not None else None,
                    radius=self.coverage_radius, device=self.device,
                    graph=self.graphed)
        if self.roi is not None:
            # retrieve_shape's window branch
            roi = self.roi
            B = len(self.mesh_db) * self.retrieval_yaws
            hyps = self._f32(np.tile(poses[:1], (B, 1, 1)))
            mi = torch.zeros(B, dtype=torch.int64, device=self.device)
            org = torch.zeros(2, dtype=torch.float32, device=self.device)
            box = self._f32([0, 0, roi[1], roi[0]])
            run = (retrieval_executor(self.mrenderer, roi, B) if self.graphed
                   else lambda *a: retrieval_scores(self.mrenderer, roi, *a))
            for _ in range(calls):
                run(hyps, mi, org, edge, edge, box)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.time() - t0

    def graphs(self) -> dict:
        """The executors' runners on this mapper's renderer
        (`utils.graphs.CallGraph`), by (cache, key)."""
        out = {}
        for cache in EXECUTOR_CACHES:
            for k, run in self.mrenderer.__dict__.get(cache, {}).items():
                out[cache, k] = getattr(run, "graph", run)
        return out

    @property
    def captures(self) -> int:
        """CUDA graphs captured for this mapper's executors."""
        return sum(g.captures for g in self.graphs().values())

    @property
    def capture_ms(self) -> List[float]:
        """Host ms of each capture, executor by executor."""
        return [ms for g in self.graphs().values() for ms in g.capture_ms]

    def _init_pose_cm(self, bbox, model_name: Optional[str] = None
                      ) -> np.ndarray:
        """Back-project the detection center at a depth estimate.

        When the model is known, depth comes from the bbox height and the
        model's physical height (z ~ fy * H_model / h_px, monocular
        scale-from-detection); otherwise the static depth_prior. The
        spawn CEM closes the residual."""
        cx = 0.5 * (bbox.top_left_x + bbox.bottom_right_x)
        cy = 0.5 * (bbox.top_left_y + bbox.bottom_right_y)
        h_px = abs(bbox.bottom_right_y - bbox.top_left_y)
        z = self.depth_prior
        c0 = np.zeros(3)
        if model_name in self._mesh_aabb and h_px > 4:
            lo, hi = self._mesh_aabb[model_name]
            c0 = 0.5 * (np.asarray(lo) + hi)   # model AABB center
            # initial pinhole estimate, then Newton-refine against the
            # PROJECTED AABB height: a 3D object's bbox spans more than
            # fy*H/z (front corners sit closer than the centroid). Yaw
            # rotation is about y, so the model's y-extent (and this
            # estimate) is yaw-invariant. The AABB CENTER (not the model
            # origin, which can sit far off-center) is what lands on the
            # detection's center ray.
            z = float(np.clip(self.intr.fy * (hi[1] - lo[1]) / h_px,
                              0.3, 0.9 * self.intr.z_far))
            corners = _aabb_corners(lo, hi) - c0
            for _ in range(3):
                c = corners + [(cx - self.intr.cx) / self.intr.fx * z,
                               (cy - self.intr.cy) / self.intr.fy * z, z]
                zc = np.maximum(c[:, 2], 0.1)
                v = self.intr.fy * c[:, 1] / zc + self.intr.cy
                h_proj = v.max() - v.min()
                z = float(np.clip(z * h_proj / h_px, 0.3,
                                  0.9 * self.intr.z_far))
        X_cam = np.array([(cx - self.intr.cx) / self.intr.fx * z,
                          (cy - self.intr.cy) / self.intr.fy * z, z])
        T_cm = np.eye(4)
        T_cm[:3, 3] = X_cam - c0
        return T_cm

    def retrieve_shape(self, bbox, edge_map, dt=None):
        """Detection-driven CAD retrieval. For a detection with no usable
        shape_id: score every candidate mesh (class-substring filtered)
        over a yaw sweep at the back-projected detection pose in ONE
        batched render across ALL (mesh, yaw) pairs, with the detection's
        azimuth distribution as a -log prior when present. dt: optionally
        pass a precomputed edge_distance_transform(edge_map) (step()
        shares one across all detections of a frame). When `roi` is set,
        candidates render into a window centered on the detection instead
        of the full frame; scoring masks coverage to the window-clipped
        bbox, identical argmax semantics. Returns (name, pose_cm (4,4),
        score) or None if the database is empty."""
        cls = (bbox.class_name or "").lower()
        cands = [n for n in self.mesh_db if cls and cls in n.lower()] \
            or list(self.mesh_db)
        if not cands:
            return None
        B = self.retrieval_yaws
        yaws = np.arange(B) * (2 * np.pi / B)
        # rotate about the model/camera Y axis: right-multiply = about the
        # object center
        cs, sn = np.cos(yaws), np.sin(yaws)
        Ry = np.zeros((B, 3, 3))
        Ry[:, 0, 0] = cs
        Ry[:, 0, 2] = sn
        Ry[:, 2, 0] = -sn
        Ry[:, 2, 2] = cs
        Ry[:, 1, 1] = 1.0
        # per-candidate depth from the bbox height + candidate's physical
        # height (see _init_pose_cm). Yaw rotates about each model's AABB
        # CENTER (t = X_cam - Ry @ c0): composing T0 @ Ry would swing an
        # off-center model off the detection ray as yaw is enumerated.
        hyp_list = []
        aabbs = [self._mesh_aabb.get(c, (np.full(3, -0.5), np.full(3, 0.5)))
                 for c in cands]
        for c, (lo, hi) in zip(cands, aabbs):
            c0 = 0.5 * (np.asarray(lo) + hi)
            X_cam = self._init_pose_cm(bbox, c)[:3, 3] + c0
            h = np.broadcast_to(np.eye(3, 4), (B, 3, 4)).copy()
            h[:, :3, :3] = Ry
            h[:, :3, 3] = X_cam[None] - Ry @ c0
            hyp_list.append(h)
        hyps = np.concatenate(hyp_list)

        # bbox aspect consistency: every candidate is height-fitted to the
        # detection, so a wrong-shape candidate becomes a scale-fitted
        # decoy; the detection's WIDTH is independent evidence. Penalize
        # |log(aspect_proj / aspect_bbox)| per (candidate, yaw).
        bb_w = max(abs(bbox.bottom_right_x - bbox.top_left_x), 1e-6)
        bb_h = max(abs(bbox.bottom_right_y - bbox.top_left_y), 1e-6)
        aspect_pen = np.zeros((len(cands), B), np.float32)
        for ci, (lo, hi) in enumerate(aabbs):
            corners = _aabb_corners(lo, hi)
            for bi in range(B):
                P = hyp_list[ci][bi]
                pc = corners @ P[:, :3].T + P[:, 3]
                zc = np.maximum(pc[:, 2], 0.1)
                u = self.intr.fx * pc[:, 0] / zc
                v = self.intr.fy * pc[:, 1] / zc
                asp = (u.max() - u.min()) / max(v.max() - v.min(), 1e-6)
                aspect_pen[ci, bi] = 2.0 * abs(
                    np.log(max(asp, 1e-6) / (bb_w / bb_h)))

        prior = np.zeros(B, np.float32)
        ap = np.asarray(bbox.azimuth_prob, np.float32).ravel()
        if ap.size > 0 and self.azimuth_prior_weight > 0:
            p = ap / max(float(ap.sum()), 1e-6)
            bins = np.minimum((yaws / (2 * np.pi) * ap.size).astype(int),
                              ap.size - 1)
            prior = -self.azimuth_prior_weight * np.log(p[bins] + 1e-3)

        em = self._f32(edge_map)
        if dt is None:
            dt = edge_distance_transform(em)
        # coverage LOCAL to the detection: only edges inside the (20%-
        # expanded) bbox count as this object's evidence; the chamfer term
        # still uses the full dt
        H, W = self.intr.rows, self.intr.cols
        mx = 0.2 * (bbox.bottom_right_x - bbox.top_left_x)
        my = 0.2 * (bbox.bottom_right_y - bbox.top_left_y)
        x0 = int(np.clip(bbox.top_left_x - mx, 0, W))
        x1 = int(np.clip(bbox.bottom_right_x + mx, 0, W))
        y0 = int(np.clip(bbox.top_left_y - my, 0, H))
        y1 = int(np.clip(bbox.bottom_right_y + my, 0, H))
        idxs = np.array([self.mrenderer.index(n) for n in cands], np.int64)
        Mc = len(cands)
        mi = torch.as_tensor(np.repeat(idxs, B), device=self.device)
        hyps_d = self._f32(hyps)
        if self.roi is not None:
            # window centered on the detection (Python's round: half to
            # even); the scoring region is the window, the same for every
            # candidate, hence the same argmax
            Hr, Wr = self.roi
            cx = 0.5 * (bbox.top_left_x + bbox.bottom_right_x)
            cy = 0.5 * (bbox.top_left_y + bbox.bottom_right_y)
            ox = float(np.clip(round(cx - Wr / 2), 0, W - Wr))
            oy = float(np.clip(round(cy - Hr / 2), 0, H - Hr))
            args = (hyps_d, mi, self._f32([ox, oy]), dt, em,
                    self._f32([x0, y0, x1, y1]))
            dev_scores = (
                retrieval_executor(self.mrenderer, (Hr, Wr), len(hyps))(*args)
                if self.graphed
                else retrieval_scores(self.mrenderer, (Hr, Wr), *args))
        else:
            # one full-frame pass over all (mesh, yaw) hypotheses
            box_mask = np.zeros((H, W), np.float32)
            box_mask[y0:y1, x0:x1] = 1.0
            dev_scores = occlusion_aware_edge_score(
                self.mrenderer.render_depth(hyps_d, mi), None, dt,
                em * self._f32(box_mask))
        scores = dev_scores.cpu().numpy().reshape(Mc, B) \
            + prior[None, :] + aspect_pen
        m, b = np.unravel_index(int(np.argmin(scores)), scores.shape)
        T = np.eye(4)
        T[:3, :4] = hyps[m * B + b]
        return cands[m], T, float(scores[m, b])

    def _spawn(self, bbox, gwc: np.ndarray,
               edge_map=None, dt=None) -> Optional[ObjectTrack]:
        name = bbox.shape_id or bbox.class_name
        if name in self.mesh_db:
            T_cm = self._init_pose_cm(bbox, name)
        elif edge_map is not None:
            got = self.retrieve_shape(bbox, edge_map, dt=dt)
            if got is None:
                return None
            name, T_cm, _ = got
        else:
            return None
        T_wm = np.eye(4)
        T_wm[:3, :4] = gwc @ T_cm
        tr = ObjectTrack(oid=self._next_id, model_name=name, pose_wm=T_wm)
        self._next_id += 1
        self.tracks[tr.oid] = tr
        return tr

    def step(self, gwc: np.ndarray, edge_map, bboxes=None) -> None:
        """gwc (3,4) camera->world; edge_map (H,W) in [0,1], numpy or a
        tensor; bboxes optional BoundingBoxList for spawning.

        Edge maps may be stored at a different resolution than the camera
        (EdgeMap carries its own rows/cols); they are resampled to the
        render resolution so scores compare pixels to pixels. A tensor of
        the right shape on the mapper's device passes through as it is
        (the production path: depth_edge output stays on the card).

        Profiler ranges (visma_tpu_torch/profile_semantic.py reads them):
        `semantic.spawn` and `semantic.refine` here; inside the CEM
        `semantic.edt`, `semantic.occluders`, `semantic.raster` (setup +
        chunk_raster_batched) and `semantic.score` (edge_score: edges,
        chamfer and coverage in one kernel call)."""
        H, W = self.intr.rows, self.intr.cols
        if tuple(edge_map.shape) != (H, W):
            if isinstance(edge_map, torch.Tensor):
                edge_map = edge_map.cpu().numpy()
            edge_map = np.asarray(edge_map, np.float32)
            ri = (np.arange(H) * edge_map.shape[0] // H).astype(np.int64)
            ci = (np.arange(W) * edge_map.shape[1] // W).astype(np.int64)
            edge_map = edge_map[ri][:, ci]
        edge_map = self._f32(edge_map)
        gwc = np.asarray(gwc, np.float64)
        G = np.eye(4)
        G[:3, :4] = gwc
        G_cw = np.linalg.inv(G)

        if bboxes is not None:
            # breaking the async steady state: refresh the host mirror
            # first so _covered dedups and spawns against the freshest
            # device-resident poses
            self._sync_dev()
            dt = None
            for bb in bboxes.bounding_boxes:
                if not self._covered(bb, gwc):
                    if (dt is None
                            and (bb.shape_id or bb.class_name)
                            not in self.mesh_db):
                        # one distance transform shared by every
                        # retrieval this frame
                        dt = edge_distance_transform(edge_map)
                    with record_function("semantic.spawn"):
                        self._spawn(bb, gwc, edge_map, dt=dt)

        tracks = list(self.tracks.values())
        if tracks:
            settled = (self.settle_age >= 0 and
                       all(tr.age >= self.settle_age for tr in tracks))
            iters = (self.settled_iters if settled and self.settled_iters
                     else self.cem_iters)
            samples = (self.settled_samples
                       if settled and self.settled_samples
                       else self.cem_samples)
            sigma = (self.settled_sigma if settled and self.settled_sigma
                     else self.init_sigma)
            roi = (self.roi if self.roi_spawn
                   or all(tr.age >= 1 for tr in tracks) else None)

            oids = [tr.oid for tr in tracks]
            can_async = (self.async_frames > 0 and settled
                         and roi is not None and bboxes is None
                         and self._dev is not None
                         and self._dev["oids"] == oids)
            with record_function("semantic.refine"):
                if can_async:
                    self._step_async(tracks, G, G_cw, edge_map, iters,
                                     samples, sigma, roi)
                else:
                    # the sync path while async steps are pending: pull
                    # the device-resident refinements down so CEM
                    # re-initializes from them
                    self._sync_dev()
                    self._step_sync(tracks, G, G_cw, edge_map, iters,
                                    samples, sigma, roi, oids)
        else:
            self.history.append([])
        self._frame_no += 1

    def _step_sync(self, tracks, G, G_cw, edge_map, iters, samples, sigma,
                   roi, oids) -> None:
        poses_cm = np.stack([(G_cw @ tr.pose_wm)[:3, :4]
                             for tr in tracks]).astype(np.float32)
        mesh_idx = np.array(
            [self.mrenderer.index(tr.model_name) for tr in tracks],
            np.int64)

        need_occ = len(tracks) > 1 and self._footprints_may_overlap(
            poses_cm, [tr.model_name for tr in tracks], sigma)
        occ = occ_poses = None
        if need_occ and roi is not None:
            # ROI mode: occluders render inside each track's window, in
            # the same CEM iteration (see cem._render_score_nS occ_poses)
            occ_poses = poses_cm
        elif need_occ:
            # full-frame mode (fresh spawns): all current depths + the
            # per-track exclusive min over the others
            args = (self._f32(poses_cm),
                    torch.as_tensor(mesh_idx, device=self.device))
            occ = (exclusive_min_executor(self.mrenderer)(*args)
                   if self.graphed else
                   _exclusive_min_depths(self.mrenderer.Cs, *args,
                                         self.mrenderer.intr))
        # disjoint screen footprints: no occluder work at all

        refined_dev, scores_dev = refine_pose_cem_batched(
            self.mrenderer, edge_map, poses_cm, mesh_idx,
            iters=iters, samples=samples, init_sigma=sigma,
            seed=min(tr.age for tr in tracks),
            occluder_depths=occ, roi=roi, occluder_poses=occ_poses,
            radius=self.coverage_radius, device=self.device,
            graph=self.graphed)
        refined = refined_dev.cpu().numpy()
        scores = scores_dev.cpu().numpy()
        for i, tr in enumerate(tracks):
            T_cm = np.eye(4)
            T_cm[:3, :4] = refined[i]
            tr.pose_wm = G @ T_cm
            tr.score = float(scores[i])
            tr.age += 1
        # seed the device-resident state for a possible async steady state
        if self.async_frames > 0:
            self._dev = {
                "poses": refined_dev, "G": G.copy(), "oids": oids,
                "pending": 0, "scores": scores_dev,
                "mi": torch.as_tensor(mesh_idx, device=self.device),
            }
        self.history.append(self.export_packet())

    def _step_async(self, tracks, G, G_cw, edge_map, iters, samples, sigma,
                    roi) -> None:
        """Device-resident settled-state step: one fused CEM enqueued, no
        value read back (see __init__ docstring)."""
        dev = self._dev
        dG = (G_cw @ dev["G"])[:3, :4].astype(np.float32)
        poses_dev = _compose_dg(self._stage(dG), dev["poses"])

        # conservative occlusion decision from the host mirror (stale by
        # <= async_frames frames; the 3-sigma margin covers the drift)
        mirror_cm = np.stack([(G_cw @ tr.pose_wm)[:3, :4]
                              for tr in tracks]).astype(np.float32)
        need_occ = len(tracks) > 1 and self._footprints_may_overlap(
            mirror_cm, [tr.model_name for tr in tracks], sigma)

        n = len(tracks)
        sig_key = ("sig", sigma, n)
        if dev.get(sig_key) is None:
            dev[sig_key] = self._f32(_sigma6(sigma, n))
        if self._gen is None:
            self._gen = torch.Generator(device=self.device)
        gen = self._gen
        gen.manual_seed(self._frame_no)
        refined_dev, scores_dev = _cem_run(
            self.mrenderer, self.graphed, dev["mi"],
            poses_dev[:, :, :3].contiguous(), poses_dev[:, :, 3].contiguous(),
            dev[sig_key], None, edge_map, gen, CEM_TAU, iters, samples,
            cem_n_elite(samples), roi, poses_dev if need_occ else None,
            self.coverage_radius)

        dev.update(poses=refined_dev, G=G.copy(), scores=scores_dev,
                   pending=dev["pending"] + 1)
        for tr in tracks:
            tr.age += 1
        # lazy history packet: materialized by finalize()
        self.history.append(("dev", G.copy(), refined_dev,
                             [(tr.oid, tr.model_name, tr.status)
                              for tr in tracks]))
        if dev["pending"] >= self.async_frames:
            self._sync_dev()

    def _sync_dev(self) -> None:
        """Refresh the host mirror (ObjectTrack poses/scores) from the
        device-resident state. Waits for the enqueued steps."""
        if self._dev is None or self._dev["pending"] == 0:
            return
        poses = self._dev["poses"].cpu().numpy()
        scores = self._dev["scores"].cpu().numpy()
        G = self._dev["G"]
        for i, oid in enumerate(self._dev["oids"]):
            tr = self.tracks.get(oid)
            if tr is None:
                continue
            T_cm = np.eye(4)
            T_cm[:3, :4] = poses[i]
            tr.pose_wm = G @ T_cm
            tr.score = float(scores[i])
        self._dev["pending"] = 0

    def finalize(self) -> None:
        """Sync the host mirror and materialize lazy history packets.
        Idempotent; called by write_result_json."""
        self._sync_dev()
        for k, packet in enumerate(self.history):
            if not (isinstance(packet, tuple) and packet
                    and packet[0] == "dev"):
                continue
            _, G, refined_dev, metas = packet
            poses = refined_dev.cpu().numpy()
            out = []
            for i, (oid, name, status) in enumerate(metas):
                T_cm = np.eye(4)
                T_cm[:3, :4] = poses[i]
                T_wm = G @ T_cm
                out.append({"id": oid, "model_name": name,
                            "status": status,
                            "model_pose": [float(x) for x in
                                           T_wm[:3, :4].reshape(-1)]})
            self.history[k] = out

    def _footprints_may_overlap(self, poses_cm: np.ndarray,
                                names: List[str],
                                sigma: Optional[tuple] = None) -> bool:
        """Conservative screen-space disjointness test: each object's
        model-frame AABB corners are projected at its current pose and the
        screen rectangle is expanded by the 3-sigma CEM search radius
        (translation sigma plus the rotational sigma times the object's
        AABB half-diagonal). sigma: the ACTIVE (rot, trans) schedule
        sigmas; defaults to init_sigma. True = some pair may overlap ->
        render occluder z-buffers. Host arithmetic on 8 points per
        object."""
        s_rot, s_trans = sigma if sigma is not None else self.init_sigma
        rects = []
        for pose, name in zip(poses_cm, names):
            lo, hi = self._mesh_aabb.get(
                name, (np.full(3, -1.0), np.full(3, 1.0)))
            half_diag = 0.5 * float(np.linalg.norm(np.asarray(hi) - lo))
            margin = 3.0 * (s_trans + s_rot * half_diag)
            pc = _aabb_corners(lo, hi) @ np.asarray(pose[:3, :3]).T \
                + pose[:3, 3]
            z = pc[:, 2]
            if np.any(z <= 0.1):
                return True          # degenerate: be conservative
            u = self.intr.fx * pc[:, 0] / z + self.intr.cx
            v = self.intr.fy * pc[:, 1] / z + self.intr.cy
            mpx = max(self.intr.fx, self.intr.fy) * margin / float(z.min())
            rects.append((u.min() - mpx, u.max() + mpx,
                          v.min() - mpx, v.max() + mpx))
        for i in range(len(rects)):
            for j in range(i + 1, len(rects)):
                a, b = rects[i], rects[j]
                if a[0] <= b[1] and b[0] <= a[1] \
                        and a[2] <= b[3] and b[2] <= a[3]:
                    return True
        return False

    def _covered(self, bbox, gwc: np.ndarray, iou_thresh: float = 0.5
                 ) -> bool:
        """Does an existing track already explain this detection? IoU
        between the detection box and each track's PROJECTED AABB
        rectangle (two neighboring objects have distinct, partially
        overlapping boxes, and IoU separates them)."""
        bx0, bx1 = sorted((bbox.top_left_x, bbox.bottom_right_x))
        by0, by1 = sorted((bbox.top_left_y, bbox.bottom_right_y))
        b_area = max(bx1 - bx0, 0.0) * max(by1 - by0, 0.0)
        if b_area <= 0:
            return True          # degenerate detection: nothing to spawn
        G = np.eye(4)
        G[:3, :4] = gwc
        G_cw = np.linalg.inv(G)
        for tr in self.tracks.values():
            lo, hi = self._mesh_aabb.get(
                tr.model_name, (np.full(3, -0.5), np.full(3, 0.5)))
            P = G_cw @ tr.pose_wm
            pc = _aabb_corners(lo, hi) @ P[:3, :3].T + P[:3, 3]
            z = pc[:, 2]
            if np.any(z <= 0.1):
                continue         # a behind-camera track cannot explain an
                                 # in-image detection
            u = self.intr.fx * pc[:, 0] / z + self.intr.cx
            v = self.intr.fy * pc[:, 1] / z + self.intr.cy
            ix0, ix1 = max(u.min(), bx0), min(u.max(), bx1)
            iy0, iy1 = max(v.min(), by0), min(v.max(), by1)
            inter = max(ix1 - ix0, 0.0) * max(iy1 - iy0, 0.0)
            t_area = (u.max() - u.min()) * (v.max() - v.min())
            union = max(b_area + t_area - inter, 1e-6)
            if inter / union > iou_thresh:
                return True
        return False

    def export_packet(self) -> List[dict]:
        """One result.json packet (evaluation.cpp:163-198 layout)."""
        out = []
        for tr in self.tracks.values():
            out.append({
                "id": tr.oid,
                "model_name": tr.model_name,
                "status": tr.status,
                "model_pose": [float(x)
                               for x in tr.pose_wm[:3, :4].reshape(-1)],
            })
        return out

    def write_result_json(self, path: str) -> None:
        self.finalize()
        with open(path, "w") as fp:
            json.dump(self.history, fp, indent=1)


def _compose_dg(dG34: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
    """pose_cm' = dG @ pose_cm for a (n,3,4) stack; dG34 (3,4) is the
    relative camera transform G'_cw @ G (float32 products, TF32 off)."""
    Rp = torch.einsum("ij,njk->nik", dG34[:, :3], poses[:, :, :3])
    tp = torch.einsum("ij,nj->ni", dG34[:, :3], poses[:, :, 3]) + dG34[:, 3]
    return torch.cat([Rp, tp[:, :, None]], dim=2)


def _exclusive_min_depths(Cs, poses, mesh_idx, intr) -> torch.Tensor:
    """Render all n tracks' current depths full-frame and return, per
    track, the min depth over the OTHER tracks (+inf background): (n,H,W).
    """
    d = rasterize_depth_chunked_multi(Cs, poses, mesh_idx, intr)
    n = d.shape[0]
    other = ~torch.eye(n, dtype=torch.bool, device=d.device)
    inf = torch.full_like(d[None], float("inf"))
    return torch.where(other[:, :, None, None], d[None], inf).amin(dim=1)


def exclusive_min_executor(mrenderer) -> CallGraph:
    """`_exclusive_min_depths` on the renderer's mesh stack as a captured
    CUDA graph replayed once a call, keyed by the number of tracks (a
    `utils.graphs.CallGraph`; on the CPU its buffers without capture), the
    counterpart of the reference's `_exclusive_min_depths_jit`
    (visma_tpu/semantic/mapper.py:760-785). Called with (poses (n,3,4),
    mesh_idx (n,)); cached on the renderer and dropped with its stack."""
    cache = mrenderer.__dict__.setdefault("_occ_exec_cache", {})
    if "min_depths" not in cache:
        Cs, intr = mrenderer.Cs, mrenderer.intr
        cache["min_depths"] = CallGraph(
            lambda poses, mesh_idx: _exclusive_min_depths(Cs, poses,
                                                          mesh_idx, intr))
    return cache["min_depths"]
