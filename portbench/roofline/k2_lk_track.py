"""K2, `lk_track` (csrc/lk_level.cu): one tracked frame of K features,
every pyramid level coarse to fine and the forward-backward pass. Bytes:
per level and for the backward pass, K windows of wl x wl float32 from each
of the two images, read once; the points and flags in and out. Operations:
per feature, level and iteration about 30 on each of the (2r+1)^2 template
pixels. chip_smoke.py at 43be5d3 counts the same: 0.000661 ms for K = 96,
4 levels, windows of 24, radius 5, 8 iterations."""

DEVICE_NAMES = ("lk_track_kernel",)


def _window(h: int, w: int, win: int, radius: int) -> int:
    wl = min(win, h - h % 8 or h, w - w % 8 or w)
    return 0 if wl < 2 * radius + 4 else wl


def work(shapes: dict, launches: int = 1):
    K, levels = shapes["max_tracks"], shapes["levels"]
    win, r, iters = shapes["lk_window"], shapes["lk_radius"], shapes["lk_iters"]
    h, w = shapes["rows"], shapes["cols"]
    wins = []
    for _ in range(levels):
        wins.append(_window(h, w, win, r))
        h, w = h // 2, w // 2
    n_bytes = sum(2 * K * x * x * 4 for x in wins + wins[:1]) \
        + 2 * (K * 2 * 4) + 2 * K
    m = 2 * r + 1
    return launches * n_bytes, launches * K * (levels + 1) * iters * m * m * 30
