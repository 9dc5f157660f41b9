"""Semi-automatic ground-truth object-pose annotation (port of
visma_tpu/cli/annotate.py; reference parity: src/annotation.cpp — per-object
yaw-enumeration ICP, alignment.json output). Runs on the CUDA card unless
`--device cpu` is given."""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("scan", help="scene point cloud (.ply)")
    ap.add_argument("cad_root", help="CAD database directory")
    ap.add_argument("models", nargs="+",
                    help="model names to register (e.g. chair chair swivel)")
    ap.add_argument("--output", default="alignment.json")
    ap.add_argument("--num-yaw", type=int, default=24)
    ap.add_argument("--voxel", type=float, default=0.01)
    ap.add_argument("--max-distance", type=float, default=0.02)
    ap.add_argument("--samples", type=int, default=5000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from visma_tpu_torch.utils.platform import configure_platform

    device = configure_platform(args.device)

    from visma_tpu_torch.align import register_model_to_scene
    from visma_tpu_torch.eval import sample_mesh
    from visma_tpu_torch.io import load_mesh, load_ply
    from visma_tpu_torch.io.json_io import matrix_to_json

    scene, _ = load_ply(args.scan)
    out, fits = {}, {}
    for idx, name in enumerate(args.models):
        V, F = load_mesh(os.path.join(args.cad_root, name + ".obj"))
        model_pts = sample_mesh(V, F, args.samples).astype(np.float32)
        T, res = register_model_to_scene(
            model_pts, scene.astype(np.float32), num_yaw=args.num_yaw,
            max_distance=args.max_distance, voxel=args.voxel, device=device)
        print(f"{name}_{idx}: fitness={res.fitness:.3f} "
              f"rmse={res.inlier_rmse:.4f} corr={res.correspondences}")
        matrix_to_json(out, f"{name}_{idx}", T[:3, :4])
        fits[f"{name}_{idx}"] = res

    with open(args.output, "w") as fp:
        json.dump(out, fp, indent=2)
    print(f"wrote {args.output}")
    return fits


if __name__ == "__main__":
    main()
