"""Prepare VISMA sequences for SfMLearner-style training (port of
visma_tpu/cli/prepare_sfmlearner.py; reference parity:
scripts/prepare_data_for_SfMLearner.py + generate_all.sh). Host work only
(numpy + cv2): it takes no --device.

For each frame i with both neighbors at +-stride: resize the triplet to
250x480, concatenate horizontally -> %06d.jpg; pickle {gwc (3,3x4),
Rg (3,3x3)} -> %06d.pkl; optionally resize the .depth map (nearest) ->
%06d_depth.npy. The canonical 8 VISMA sequences are listed in
`CANONICAL_SEQUENCES` (generate_all.sh:5-12).
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

OUT_HEIGHT, OUT_WIDTH = 250, 480

CANONICAL_SEQUENCES = [
    "clutter1", "clutter2", "leather_chair", "occlusion1", "occlusion2",
    "swivel_chair", "swivel_chair_lateral", "double_swivel_chairs_whiteboard",
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataroot")
    ap.add_argument("output_dir")
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--ignore-static", type=int, default=0,
                    help="skip the first N (static) frames")
    ap.add_argument("--process-depth", action="store_true")
    args = ap.parse_args(argv)

    import cv2

    from visma_tpu_torch.io import VlslamDatasetLoader, load_mat

    loader = VlslamDatasetLoader(args.dataroot)
    os.makedirs(args.output_dir, exist_ok=True)

    def depth_path_for(i):
        stem = os.path.splitext(os.path.basename(loader.png_files[i]))[0]
        return os.path.join(args.dataroot, stem + ".depth")

    total = len(loader)
    written = 0
    for i in range(args.ignore_static, total):
        if i - args.stride < 0 or i + args.stride >= total:
            continue
        imgs, poses, rotations = [], [], []
        for j in (i - args.stride, i, i + args.stride):
            fr = loader.grab(j)
            if fr.image is None:
                break
            imgs.append(cv2.resize(fr.image, (OUT_WIDTH, OUT_HEIGHT),
                                   interpolation=cv2.INTER_LINEAR))
            poses.append(fr.gwc)
            rotations.append(fr.Rg)
        if len(imgs) != 3:
            continue
        concat = np.concatenate(imgs, axis=1)
        cv2.imwrite(os.path.join(args.output_dir, f"{i:06d}.jpg"), concat)
        with open(os.path.join(args.output_dir, f"{i:06d}.pkl"), "wb") as fp:
            pickle.dump({"gwc": np.asarray(poses), "Rg": np.asarray(rotations)},
                        fp)
        if args.process_depth and os.path.exists(depth_path_for(i)):
            depth = load_mat(depth_path_for(i))
            depth = cv2.resize(depth, (OUT_WIDTH, OUT_HEIGHT),
                               interpolation=cv2.INTER_NEAREST)
            np.save(os.path.join(args.output_dir, f"{i:06d}_depth.npy"), depth)
        written += 1
    print(f"wrote {written} triplets to {args.output_dir}")


if __name__ == "__main__":
    main()
