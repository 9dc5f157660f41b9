"""Batch-undistort Corvis camera images to VGA-ish size
(port of visma_tpu/cli/undistort_images.py; reference parity:
example/undistort_images.cpp — hardcoded ATAN calib, 600x960 -> crop solve
-> keep central 500 rows; writes in place unless --output is given)."""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("directory", help="directory of .png images")
    ap.add_argument("--output", default=None,
                    help="output dir (default: overwrite in place, like the "
                         "reference)")
    ap.add_argument("--calib", default=None,
                    help="calibration file (default: hardcoded Corvis ATAN)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from visma_tpu_torch.utils.platform import configure_platform

    device = configure_platform(args.device)

    import cv2
    import numpy as np
    import torch

    from visma_tpu_torch.image import bilinear_remap
    from visma_tpu_torch.image.undistort import (CORVIS_ATAN_CALIB,
                                                 corvis_undistorter,
                                                 undistorter_from_file)
    from visma_tpu_torch.io import glob_by_timestamp

    und = (undistorter_from_file(args.calib, device=device) if args.calib
           else corvis_undistorter(device=device))
    crop_top = CORVIS_ATAN_CALIB["crop_top"] if args.calib is None else 0
    final_rows = (CORVIS_ATAN_CALIB["final_rows"] if args.calib is None
                  else und.out_rows)

    K = und.K.copy()
    K[1, 2] -= crop_top
    print(f"output K: fx={K[0,0]:.3f} fy={K[1,1]:.3f} "
          f"cx={K[0,2]:.3f} cy={K[1,2]:.3f} rows={final_rows} "
          f"cols={und.out_cols}")

    files = glob_by_timestamp(args.directory, ".png")
    # the crop is a slice of the table: the rows that would be thrown away
    # are never remapped
    remap = und.remap[crop_top:crop_top + final_rows]
    if args.output:
        os.makedirs(args.output, exist_ok=True)
    for path in files:
        img = cv2.imread(path)
        if img is None:
            raise IOError(f"cannot read image {path}")
        if img.shape[:2] != (und.in_rows, und.in_cols):
            raise ValueError(
                f"{path} is {img.shape[0]}x{img.shape[1]}, the calibration "
                f"is for {und.in_rows}x{und.in_cols}")
        out = bilinear_remap(torch.as_tensor(np.ascontiguousarray(img),
                                             device=device), remap)
        dst = (path if args.output is None else
               os.path.join(args.output, os.path.basename(path)))
        cv2.imwrite(dst, out.cpu().numpy())
        print(dst)


if __name__ == "__main__":
    main()
