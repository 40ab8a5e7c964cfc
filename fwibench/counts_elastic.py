"""Operations and bytes of one elastic P-SV shot, as the algorithm needs
them, and the least time the card could take for them (the elastic
counterpart of ``counts.py``, whose constants and bound it shares).

A pure function of the shot's shapes: the padded grid, the order and CPML
width, nt, the sources and the recorded values a step. The arithmetic is
the port's own (``chip_smoke.py`` ``elastic_step_counts``: the whole-scan
forward with its five-field ring tape, ``escan_forward_rings``, and the
reverse, ``escan_reverse``), copied here so that the count stays the same
whatever engine does the work. A field of the grid fits the card's 50 MB
L2, so a step moves only its wavelet sample, its recorded values, its
sources and its tape row; the fields and the materials move once a shot.

- forward, a cell: 8 staggered derivatives of R taps (a subtraction and an
  FMA a tap) and the updates, 16 R + 20; a CPML strip cell its 4 memories,
  12; per step the ring tape's five fields written;
- reverse, a cell: the reconstruction, the transposed derivatives and the
  imaging, 32 R + 60; a strip cell 20; per step the tape row read.
"""

from __future__ import annotations

from fwibench.counts import F, ring_cells, step_bound_s


def passes(shape, order: int, pml: int, nt: int, nsrc: int, nrec_cols: int, tape,
           reverse: bool):
    """{pass: (flops a step, bytes a step, bytes a shot)} of one shot: its
    forward and, with ``reverse``, its reverse. ``nrec_cols``: recorded
    values a step (2 nrec for two components); ``tape``: None or ("rings",
    "float32"), the only tape the elastic engines keep."""
    if tape is not None and tuple(tape) != ("rings", "float32"):
        raise ValueError(f"elastic tape {tape!r}: the elastic engines keep an fp32 ring tape")
    r = order // 2
    S = pml + r
    NZ, NX = (s + 2 * S for s in shape)
    cells, strips = NZ * NX, 2 * S * (NX + NZ)
    fwd = cells * (16 * r + 20) + strips * 12 + 2 * nsrc
    rev = cells * (32 * r + 60) + strips * 20 + 4 * nsrc
    n_ring = ring_cells(shape, r) if tape is not None else 0
    out = {"forward": (fwd, (1 + nrec_cols + 5 * n_ring) * F, 10 * cells * F)}
    if reverse and tape is not None:
        out["reverse"] = (rev, (1 + nrec_cols + nsrc + 5 * n_ring) * F, 15 * cells * F)
    return out


def shot_bound_s(shape, order: int, pml: int, nt: int, nsrc: int, nrec_cols: int, tape,
                 reverse: bool) -> float:
    """Least seconds one shot can take on the card: its passes one after
    another, each at the larger of its operations and bytes bound."""
    return sum(nt * step_bound_s(c, nt)[0]
               for c in passes(shape, order, pml, nt, nsrc, nrec_cols, tape, reverse).values())
