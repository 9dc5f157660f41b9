"""K4, `chunk_raster_batched` (csrc/chunk_raster.cu): the depth windows of
one CEM iteration, one launch for the hypotheses (objects x samples
windows) and one for the occluders (objects x (objects - 1) windows).
Bytes, as chip_smoke.py counts them at 43be5d3: every input of the launch
read once (the planes of each window's chunks, the subtiles' chunk lists
and counts) and the depth written once: 68.1 MB and 0.0203 ms for 96
windows of 256x384 over 41 chunks. Operations: 16 for each (pixel,
triangle) pair whose triangle's own screen bbox holds the pixel, the pairs
a window needs as the entry module counts them at the settled poses
(`k4_pairs_per_window`)."""

# the ROI windows' instantiation (SUB_ROI = 16); <32> is K3, the full frame
DEVICE_NAMES = ("chunk_raster_kernel<16>",)


def launch(shapes: dict, windows: int):
    hr, wr, sub = shapes["roi"][0], shapes["roi"][1], shapes["sub_px"]
    nc, chunk = shapes["chunks"], shapes["chunk"]
    nsub = -(-hr // sub) * -(-wr // sub)
    n_bytes = windows * (nc * chunk * 12 * 4 + nsub * nc * 4 + nsub * 4
                         + hr * wr * 4)
    return n_bytes, 16 * windows * shapes["k4_pairs_per_window"]


def work(shapes: dict, launches: int):
    n, S = shapes["objects"], shapes["samples"]
    hyp, occ = launch(shapes, n * S), launch(shapes, n * (n - 1))
    iters = launches // 2
    return iters * (hyp[0] + occ[0]), iters * (hyp[1] + occ[1])
