"""K6, `bilinear_remap` (csrc/bilinear_remap.cu): a batch of u8 frames
undistorted through the rows of the table that the crop keeps. Bytes, as
chip_smoke.py counts them at 43be5d3: of each frame only the source pixels
that the table's four clamped taps reach (`remap_source_pixels`, which the
entry module counts from the benchmark's own table), the table (two
float32 a pixel) and the u8 output written once: 0.0688 ms for 240 frames
600x960 -> 500x960. Operations: 12 an output value (4 multiplies and 3
adds, the weights amortised)."""

DEVICE_NAMES = ("bilinear_remap_kernel",)


def work(shapes: dict, launches: int = 1):
    n, rows, cols = shapes["remap_frames"], shapes["rows"], shapes["cols"]
    n_bytes = n * shapes["remap_source_pixels"] + rows * cols * (8 + n)
    return launches * n_bytes, launches * 12 * n * rows * cols
