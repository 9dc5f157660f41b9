"""Visualize a sequence: camera trajectory + INSTATE point cloud +
optional result.json objects (port of visma_tpu/cli/visualize.py; reference
parity: VisualizeResult, src/visualization.cpp:226-313 — Open3D's live
window replaced by two headless exports: a static 3-D matplotlib figure,
and `--animate DIR`, an animated per-frame overlay render (object edges
rasterized by the port's own rasterizer at each frame's camera pose, plus
the INSTATE feature observations) written as PNG frames + an mp4 when the
cv2 codec allows). `--animate` renders on the CUDA card unless `--device
cpu` is given; the static figure is host work, drawn after it, and
needs matplotlib (`--output ''` leaves it out)."""
from __future__ import annotations

import argparse
import os

import numpy as np

# per-object BGR overlay colors (cycled)
_COLORS = [(0, 64, 255), (0, 200, 0), (255, 128, 0), (200, 0, 200),
           (0, 220, 220), (255, 0, 96)]


def overlay_frame(img, edges, colors):
    """Alpha-blend each object's edge map (its BGR color) onto a frame."""
    for e, c in zip(edges, colors):
        a = np.clip(e, 0.0, 1.0)[:, :, None]
        img = (img * (1 - 0.85 * a)
               + 0.85 * a * np.array(c)[None, None, :]).astype(np.uint8)
    return img


def packet_poses(packet, gwc, mr, mesh_db):
    """A result.json packet's objects at a frame: (model->camera poses
    (n,3,4), their mesh indices in `mr`, their overlay colors), skipping
    models missing from `mesh_db`."""
    from visma_tpu_torch.io.json_io import matrix_from_json

    G = np.eye(4)
    G[:3, :4] = gwc
    G_cw = np.linalg.inv(G)
    poses, midx, colors = [], [], []
    for obj in packet:
        name = obj["model_name"]
        if name not in mesh_db:
            continue
        T_wm = np.eye(4)
        T_wm[:3, :4] = matrix_from_json(obj, "model_pose", 3, 4)
        poses.append((G_cw @ T_wm)[:3, :4])
        midx.append(mr.index(name))
        colors.append(_COLORS[int(obj.get("id", 0)) % len(_COLORS)])
    return poses, midx, colors


def draw_features(img, packet):
    """The packet's INSTATE/GOODDROP feature observations as dots (the
    reference window's point cloud, in image space), in place."""
    import cv2

    from visma_tpu_torch.proto import FeatureStatus

    for f in packet.features:
        if len(f.xp) >= 2 and f.status in (
                FeatureStatus.INSTATE, FeatureStatus.GOODDROP):
            cv2.circle(img, (int(f.xp[0]), int(f.xp[1])), 2,
                       (0, 255, 255), -1)
    return img


def _animate(loader, result, mesh_db, out_dir: str, max_frames: int,
             device, feature_dots: bool = True) -> int:
    """Per-frame overlay renders: each result.json packet's objects are
    rasterized (edge maps, render.raster.MultiMeshRenderer: the frame's
    poses in one call, one `chunk_raster_frame` launch a pose, then one
    `depth_edge`) at that frame's camera pose and alpha-blended onto the
    frame image; INSTATE/GOODDROP feature pixels drawn as dots
    (`draw_features`). Returns the number of frames written."""
    import cv2
    import torch

    from visma_tpu_torch.render import Intrinsics
    from visma_tpu_torch.render.raster import MultiMeshRenderer

    cam = loader.grab_camera_info()
    p = np.asarray(cam.parameters)
    intr = Intrinsics(fx=float(p[0]), fy=float(p[1]), cx=float(p[2]),
                      cy=float(p[3]), rows=cam.rows, cols=cam.cols,
                      z_near=0.05, z_far=10.0)
    mr = MultiMeshRenderer(intr, device=device)
    if mesh_db:
        mr.set_meshes(mesh_db)

    os.makedirs(out_dir, exist_ok=True)
    n = min(len(loader), max_frames or len(loader))
    writer = None
    video_path = os.path.join(out_dir, "overlay.mp4")
    try:
        writer = cv2.VideoWriter(video_path,
                                 cv2.VideoWriter_fourcc(*"mp4v"), 15.0,
                                 (cam.cols, cam.rows))
        if not writer.isOpened():
            writer = None
    except Exception:
        writer = None

    for i in range(n):
        fr = loader.grab(i)
        img = fr.image
        if img is None:
            img = np.full((cam.rows, cam.cols, 3), 32, np.uint8)
        img = img.copy()

        # result.json is a list of per-timestamp packets; hold the last
        # packet once the sequence outruns it (evaluation.cpp:163 reads
        # only the final packet — the animation plays the whole history)
        packet = result[min(i, len(result) - 1)] if result else []
        if packet:
            poses, midx, colors = packet_poses(packet, fr.gwc, mr, mesh_db)
            if poses:
                edges = mr.render_edge(
                    torch.as_tensor(np.stack(poses), dtype=torch.float32),
                    torch.as_tensor(midx, dtype=torch.int64))
                img = overlay_frame(img, edges.cpu().numpy(), colors)

        if feature_dots and i < len(loader.dataset.packets):
            draw_features(img, loader.dataset.packets[i])

        cv2.imwrite(os.path.join(out_dir, f"overlay_{i:06d}.png"), img)
        if writer is not None:
            writer.write(img)
    if writer is not None:
        writer.release()
        print(f"wrote {video_path}")
    return n


def _figure(loader, args) -> None:
    """The static figure: trajectory, INSTATE/GOODDROP map points and the
    result.json objects of `--result-index`, saved to `args.output`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from visma_tpu_torch.proto import FeatureStatus

    traj = np.stack([loader.pose(i)[:, 3] for i in range(len(loader))])

    # INSTATE/GOODDROP world points over the sequence
    pts = {}
    for i in range(len(loader)):
        for f in loader.dataset.packets[i].features:
            if f.status in (FeatureStatus.INSTATE, FeatureStatus.GOODDROP) \
                    and len(f.xw) >= 3:
                pts[f.id] = f.xw[:3]
    cloud = np.asarray(list(pts.values())) if pts else np.zeros((0, 3))

    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot(traj[:, 0], traj[:, 1], traj[:, 2], "b-", lw=2,
            label=f"trajectory ({len(traj)} frames)")
    ax.scatter(traj[0, 0], traj[0, 1], traj[0, 2], c="g", s=60,
               label="start")
    if len(cloud):
        ax.scatter(cloud[:, 0], cloud[:, 1], cloud[:, 2], s=2, c="gray",
                   alpha=0.5, label=f"{len(cloud)} map points")

    result_path = os.path.join(args.dataroot, "result.json")
    if args.cad_root and os.path.exists(result_path):
        from visma_tpu_torch.eval import sample_mesh
        from visma_tpu_torch.io import load_json, load_mesh
        from visma_tpu_torch.io.json_io import matrix_from_json

        packet = load_json(result_path)[args.result_index]
        for obj in packet:
            pose34 = matrix_from_json(obj, "model_pose", 3, 4)
            V, F = load_mesh(os.path.join(args.cad_root,
                                          obj["model_name"] + ".obj"))
            s = sample_mesh(V, F, args.model_samples)
            s = s @ pose34[:, :3].T + pose34[:, 3]
            ax.scatter(s[:, 0], s[:, 1], s[:, 2], s=1,
                       label=f"{obj['model_name']}#{obj['id']}")

    ax.set_xlabel("x"); ax.set_ylabel("y"); ax.set_zlabel("z")
    ax.legend(loc="upper left", fontsize=8)
    plt.tight_layout()
    plt.savefig(args.output, dpi=110)
    plt.close(fig)
    print(f"saved {args.output}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataroot")
    ap.add_argument("--result-index", type=int, default=-1,
                    help="which result.json packet to overlay (default last)")
    ap.add_argument("--cad-root", default=None)
    ap.add_argument("--output", default="scene.png",
                    help="the static figure; empty: no figure (it needs "
                         "matplotlib, --animate does not)")
    ap.add_argument("--model-samples", type=int, default=2000)
    ap.add_argument("--animate", default=None, metavar="DIR",
                    help="export an animated per-frame overlay render "
                         "(PNG sequence + mp4) via the port's rasterizer")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device of --animate (default: the CUDA "
                         "card)")
    args = ap.parse_args(argv)

    from visma_tpu_torch.utils.platform import configure_platform

    # resolved first: without a card, --animate fails before any work
    device = configure_platform(args.device) if args.animate else None

    from visma_tpu_torch.io import VlslamDatasetLoader

    loader = VlslamDatasetLoader(args.dataroot)

    if args.animate:
        from visma_tpu_torch.io import load_json, load_mesh

        result = []
        result_path = os.path.join(args.dataroot, "result.json")
        if os.path.exists(result_path):
            result = load_json(result_path)
        mesh_db = {}
        if args.cad_root:
            names = {obj["model_name"] for pk in result for obj in pk}
            for name in sorted(names):
                for ext in (".obj", ".ply"):
                    path = os.path.join(args.cad_root, name + ext)
                    if os.path.exists(path):
                        mesh_db[name] = load_mesh(path)
                        break
        n = _animate(loader, result, mesh_db, args.animate,
                     args.max_frames, device)
        print(f"wrote {n} overlay frames to {args.animate}")

    if args.output:
        _figure(loader, args)


if __name__ == "__main__":
    main()
