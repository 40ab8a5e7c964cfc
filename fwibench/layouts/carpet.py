"""Surface shots on a (y, x) grid and a receiver carpet every
``rcv_every`` cells, 10 cells in from the sides
(``scripts/overthrust_ms.py:97-140``)."""

import numpy as np


def geometry(shape, s):
    ny, _, nx = shape
    ey, ex = s["rcv_every"]
    rcv = np.array([[y, s["rcv_depth"], x] for y in range(10, ny - 10, ey)
                    for x in range(10, nx - 10, ex)])
    sy, sx = s["shots"]
    src = np.array([[[int(y), s["src_depth"], int(x)]] for y in np.linspace(0.2 * ny, 0.8 * ny, sy)
                    for x in np.linspace(0.15 * nx, 0.75 * nx, sx)])
    return src, rcv
