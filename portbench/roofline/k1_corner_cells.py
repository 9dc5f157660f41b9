"""K1, `corner_cells` (csrc/corner_score.cu): the Shi-Tomasi map of one
frame and the best corner of each grid cell. Bytes: the frame read once,
the map written once, each cell's score, index and (x, y) written once.
Operations: about 60 a pixel (Sobel, the 5x5 box sums, the eigenvalue,
the 3x3 maximum). chip_smoke.py at 43be5d3 counts the same:
0.00115 ms at 500x960 with cells of 32."""

DEVICE_NAMES = ("corner_score_kernel",)


def work(shapes: dict, launches: int = 1):
    rows, cols, cell = shapes["rows"], shapes["cols"], shapes["cell"]
    cells = (rows // cell) * (cols // cell)
    frame = rows * cols * 4
    return (launches * (2 * frame + cells * (4 + 4 + 8)),
            launches * 60 * rows * cols)
