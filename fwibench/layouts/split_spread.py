"""Shots evenly spread along x (the ends left out), every shot recorded by
one receiver line (``tpufwi_torch.acquisition.split_spread_survey``)."""

import numpy as np


def geometry(shape, s):
    nx = shape[1]
    sx = np.linspace(0, nx - 1, s["shots"] + 2)[1:-1].round().astype(np.int64)
    src = np.array([[[s["src_depth"], x]] for x in sx])
    rx = np.arange(0, nx, s["rcv_every"])
    rcv = np.stack([np.full_like(rx, s["rcv_depth"]), rx], 1)
    return src, rcv
