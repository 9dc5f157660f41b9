"""End-to-end quantitative evaluation (port of visma_tpu/eval/evaluate.py;
reference parity: src/evaluation.cpp:114-364 MeshAlignment +
QuantitativeEvaluation).

File-format compatible with the reference flow:
  <dataroot>/<dataset>/fragments/alignment.json   GT object poses
  <dataroot>/<dataset>/result.json                per-timestamp object sets
  <dataroot>/<dataset>/test.klg.ply               RGB-D pseudo-GT cloud
  <CAD_database_root>/<model_name>.obj            CAD meshes
outputs:
  result_alignment.json (T_ef_corvis row-major 3x4)
  augmented_view.ply
  {surface,translation,rotation}_error.json

Both entry points run on the CUDA card unless `device` says otherwise:
the voxel grid, the ICP refinement and the surface error compute there;
loading, registration of object poses and the pose error are numpy.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from visma_tpu_torch.align.icp import icp
from visma_tpu_torch.align.registration import register_scenes
from visma_tpu_torch.align.voxel import voxel_downsample
from visma_tpu_torch.eval.assembly import assemble_scene
from visma_tpu_torch.eval.metrics import (measure_pose_error,
                                          measure_surface_error)
from visma_tpu_torch.eval.sampling import sample_mesh
from visma_tpu_torch.io import load_json, load_mesh, load_ply, save_json, save_ply
from visma_tpu_torch.io.json_io import matrix_from_json, matrix_to_json
from visma_tpu_torch.utils.misc import as_f32, resolve_device


def _load_gt_models(fragment_dir: str, cad_root: str, samples: int):
    """alignment.json: {"<model>_<idx>": flat 3x4 row-major} ->
    id -> {name, pose 4x4, V, F, pts} (evaluation.cpp:127-152)."""
    gt = load_json(os.path.join(fragment_dir, "alignment.json"))
    models = {}
    for counter, key in enumerate(gt.keys()):
        pose34 = matrix_from_json(gt, key, 3, 4)
        pose = np.eye(4)
        pose[:3, :4] = pose34
        name = key[: key.rfind("_")] if "_" in key else key
        V, F = load_mesh(os.path.join(cad_root, name + ".obj"))
        models[counter] = {
            "name": name, "pose": pose, "V": V, "F": F,
            "pts": sample_mesh(V, F, samples) @ pose[:3, :3].T + pose[:3, 3],
        }
    return models


def _load_result_models(scene_dir: str, cad_root: str, samples: int,
                        result_index: int = -1):
    """result.json: list over time of [{id, model_name, model_pose(3x4),
    status}, ...]; `result_index` selects the packet, a negative one the
    last (visualization.cpp:140-142, evaluation.cpp:163-198)."""
    result = load_json(os.path.join(scene_dir, "result.json"))
    if result_index < 0:
        result_index = len(result) - 1
    models = {}
    for obj in result[result_index]:
        pose34 = matrix_from_json(obj, "model_pose", 3, 4)
        pose = np.eye(4)
        pose[:3, :4] = pose34
        name = obj["model_name"]
        V, F = load_mesh(os.path.join(cad_root, name + ".obj"))
        models[int(obj["id"])] = {
            "name": name, "pose": pose, "V": V, "F": F,
            "pts": sample_mesh(V, F, samples) @ pose[:3, :3].T + pose[:3, 3],
        }
    return models


def mesh_alignment(config: Dict, device=None) -> np.ndarray:
    """Register the estimated scene to the RGB-D pseudo-GT frame and write
    result_alignment.json + augmented_view.ply (evaluation.cpp:114-241).
    Returns T_ef_corvis (4,4)."""
    dev = resolve_device(device)
    scene_dir = os.path.join(config["dataroot"], config["dataset"])
    fragment_dir = os.path.join(scene_dir, "fragments")
    cad_root = config["CAD_database_root"]
    samples = int(config.get("visualization", {}).get("model_samples", 5000))

    result_index = int(config.get("result_visualization", {})
                       .get("result_index", -1))
    models_gt = _load_gt_models(fragment_dir, cad_root, samples)
    models_est = _load_result_models(scene_dir, cad_root, samples,
                                     result_index=result_index)

    T_ef_corvis, _ = register_scenes(models_gt, models_est)

    ev = config.get("evaluation", {})
    if ev.get("ICP_refinement", False):
        scene_pts, _ = load_ply(os.path.join(scene_dir, "test.klg.ply"))
        # fallback defaults = the reference operating point
        # (cfg/tool.json:29-31, consumed at evaluation.cpp:258-271)
        spm = int(ev.get("samples_per_model", 50000))
        est_pts = np.concatenate([
            sample_mesh(m["V"], m["F"], spm) @ m["pose"][:3, :3].T
            + m["pose"][:3, 3] for m in models_est.values()])
        ds, dv = voxel_downsample(as_f32(scene_pts, dev),
                                  float(ev.get("voxel_size", 0.05)))
        res = icp(est_pts, ds,
                  max_distance=float(ev.get("max_distance", 0.075)),
                  init=T_ef_corvis,
                  point_to_plane=bool(ev.get("use_point_to_plane", False)),
                  target_valid=dv, device=dev)
        print(f"fitness={res.fitness:f}; inlier_rmse={res.inlier_rmse:f}")
        T_ef_corvis = res.transformation

    out: Dict = {}
    matrix_to_json(out, "T_ef_corvis", np.asarray(T_ef_corvis)[:3, :4])
    save_json(out, os.path.join(scene_dir, "result_alignment.json"))

    # augmented view: GT cloud + estimated models transformed into EF frame
    try:
        scene_pts, _ = load_ply(os.path.join(scene_dir, "test.klg.ply"))
        est_pts = np.concatenate([m["pts"] for m in models_est.values()])
        T = np.asarray(T_ef_corvis)
        est_in_ef = est_pts @ T[:3, :3].T + T[:3, 3]
        save_ply(os.path.join(scene_dir, "augmented_view.ply"),
                 np.concatenate([scene_pts, est_in_ef]))
    except FileNotFoundError:
        pass
    return np.asarray(T_ef_corvis)


def quantitative_evaluation(config: Dict,
                            device=None) -> Dict[str, Dict[str, float]]:
    """Full metric pipeline (evaluation.cpp:276-364): alignment, scene
    assembly, pose + surface errors, JSON artifacts. Returns the metrics."""
    dev = resolve_device(device)
    scene_dir = os.path.join(config["dataroot"], config["dataset"])
    cad_root = config["CAD_database_root"]
    samples = int(config.get("visualization", {}).get("model_samples", 5000))

    T_ef_corvis = mesh_alignment(config, device=dev)

    result_index = int(config.get("result_visualization", {})
                       .get("result_index", -1))
    models_est = _load_result_models(scene_dir, cad_root, samples,
                                     result_index=result_index)
    Vr, Fr, Gr, _ = assemble_scene(models_est, alignment=T_ef_corvis)

    models_gt = _load_gt_models(os.path.join(scene_dir, "fragments"),
                                cad_root, samples)
    Vg, Fg, Gg, _ = assemble_scene(models_gt)

    t_stats, r_stats = measure_pose_error(Gr, Gg, dist_thresh=0.5)
    # rad -> deg with the reference's own conversion constant (180/3.14,
    # evaluation.cpp:316-320)
    r_stats = r_stats.scaled(180.0 / 3.14)

    num_samples = int(min(500000, len(Fg) * 100))
    s_stats = measure_surface_error(Vr, Fr, Vg, Fg, num_samples, device=dev)

    save_json(s_stats.to_json(), os.path.join(scene_dir, "surface_error.json"))
    save_json(t_stats.to_json(),
              os.path.join(scene_dir, "translation_error.json"))
    save_json(r_stats.to_json(), os.path.join(scene_dir, "rotation_error.json"))
    return {"surface": s_stats.to_json(), "translation": t_stats.to_json(),
            "rotation": r_stats.to_json()}
