"""K5 fused, `edge_score` (csrc/depth_edge.cu: the tiles' sums, then the
scores): one CEM iteration's occlusion-aware edge score. Bytes, as
chip_smoke.py counts them at 43be5d3: every depth window read once, each
object's occluder, distance and evidence windows once, the evidence mass
and the scores written once: 42.5 MB and 0.0127 ms for 4 objects x 24
windows of 256x384. Operations: about 50 a window pixel."""

DEVICE_NAMES = ("edge_score_tiles", "edge_score_finish")


def work(shapes: dict, launches: int):
    n, S = shapes["objects"], shapes["samples"]
    px = shapes["roi"][0] * shapes["roi"][1]
    n_bytes = 4 * (n * S * px + 3 * n * px + 1 + n * S)
    return launches * n_bytes, launches * 50 * n * S * px
