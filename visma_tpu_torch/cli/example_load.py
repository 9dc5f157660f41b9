"""Iterate a VISMA sequence and print its contents
(port of visma_tpu/cli/example_load.py; reference parity:
example/example_load.cpp, scripts/example_load.py)."""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataroot", help="sequence directory containing `dataset`")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--save-vis", default=None,
                    help="directory for overlay images instead of a GUI")
    args = ap.parse_args(argv)

    from visma_tpu_torch.io import VlslamDatasetLoader
    from visma_tpu_torch.io.loader import edge_u8

    loader = VlslamDatasetLoader(args.dataroot)
    cam = loader.grab_camera_info()
    print(f"sequence: {len(loader)} frames, camera {cam.rows}x{cam.cols}, "
          f"params {np.asarray(cam.parameters)}")

    n = min(len(loader), args.max_frames or len(loader))
    for i in range(n):
        fr = loader.grab(i)
        print(f"--- frame {i} ts={fr.ts:.6f}")
        print(f"gwc=\n{fr.gwc}")
        print(f"Rg=\n{fr.Rg}")
        if fr.bboxlist is not None:
            for bb in fr.bboxlist.bounding_boxes:
                print(f"  bbox {bb.class_name}: ({bb.top_left_x:.1f},"
                      f"{bb.top_left_y:.1f})-({bb.bottom_right_x:.1f},"
                      f"{bb.bottom_right_y:.1f})")
        if args.save_vis and fr.image is not None:
            import cv2
            import os

            os.makedirs(args.save_vis, exist_ok=True)
            img = fr.image.copy()
            if fr.bboxlist is not None:
                for bb in fr.bboxlist.bounding_boxes:
                    cv2.rectangle(img, (int(bb.top_left_x), int(bb.top_left_y)),
                                  (int(bb.bottom_right_x), int(bb.bottom_right_y)),
                                  (0, 255, 0), 2)
            cv2.imwrite(f"{args.save_vis}/{i:06d}.jpg", img)
            if fr.edgemap is not None:
                cv2.imwrite(f"{args.save_vis}/{i:06d}_edge.png",
                            edge_u8(fr.edgemap))


if __name__ == "__main__":
    main()
