"""Export a VISMA sequence to per-frame files
(port of visma_tpu/cli/example_dump.py; reference parity:
example/example_dump.cpp — K.txt, pose/%06d.txt,
depth/%06d.txt with positive-y sparse samples, image/%06d.jpg)."""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataroot")
    ap.add_argument("output")
    args = ap.parse_args(argv)

    from visma_tpu_torch.io import VlslamDatasetLoader

    loader = VlslamDatasetLoader(args.dataroot)
    for sub in ("pose", "depth", "image"):
        os.makedirs(os.path.join(args.output, sub), exist_ok=True)

    cam = loader.grab_camera_info()
    p = np.asarray(cam.parameters)
    K = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1]])
    np.savetxt(os.path.join(args.output, "K.txt"), K, fmt="%10.6f")

    for i in range(len(loader)):
        fr = loader.grab(i)
        # 4x4 pose (reference writes gwc.matrix())
        G = np.eye(4)
        G[:3, :4] = fr.gwc
        np.savetxt(os.path.join(args.output, "pose", f"{i:06d}.txt"), G,
                   fmt="%10.6f")

        sd = loader.grab_sparse_depth(i)
        with open(os.path.join(args.output, "depth", f"{i:06d}.txt"), "w") as f:
            for fid, (x, y, z) in sd.items():
                if y > 0:  # reference filter: s.second[1] > 0
                    f.write(f"{x} {y} {z}\n")

        if fr.image is not None:
            import cv2

            cv2.imwrite(os.path.join(args.output, "image", f"{i:06d}.jpg"),
                        fr.image)
    print(f"dumped {len(loader)} frames to {args.output}")


if __name__ == "__main__":
    main()
