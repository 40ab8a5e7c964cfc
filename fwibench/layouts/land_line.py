"""The P-SV land survey of ``tpufwi_torch.invert.build_synthetic_elastic_problem``
(the CLI lane ``physics=elastic``): shots evenly spaced from 6 cells in to 7
from the far end, and one receiver line, every ``rcv_every`` cells from 4 in
to 4 from the far end, recording every shot."""

import numpy as np


def geometry(shape, s):
    nx = shape[1]
    sx = np.linspace(6, nx - 7, s["shots"]).astype(int)
    src = np.array([[[s["src_depth"], x]] for x in sx])
    rx = np.arange(4, nx - 4, s["rcv_every"])
    rcv = np.stack([np.full_like(rx, s["rcv_depth"]), rx], 1)
    return src, rcv
