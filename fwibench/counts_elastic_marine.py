"""Operations and bytes of one marine elastic P-SV shot (a pressure source
and hydrophones under a free surface), and the least time the card could
take for them: ``counts_elastic.passes`` with one recorded value a receiver,
less the top CPML strip, plus the free-surface images.

- The free surface takes the absorbing layer off the top side: its S NX
  strip cells (S = pml + r) keep no memories, 12 operations a cell a
  forward step and 20 a reverse step fewer.
- The images, r ghost rows of NX cells each: a forward step copies the
  two velocities' ghost rows (no operation) and negates the two shear and
  normal stresses' (2 r NX); a reverse step images the reconstructed
  primal as the forward does (2 r NX) and adds each ghost row's four
  cotangents into its mirror row, the images' transposes (4 r NX).
- Bytes: the image rows are rows of fields that stay on chip, as
  ``counts_elastic`` counts them (a field of the grid fits the card's L2),
  so the images move no device-memory bytes; a step moves its wavelet
  sample, its nrec pressures, its sources and its tape row.
"""

from __future__ import annotations

from fwibench import counts_elastic
from fwibench.counts import step_bound_s

# operations a strip cell a step that the top side's memories would take
STRIP_OPS = {"forward": 12, "reverse": 20}
# operations of one ghost-row cell a step: the forward's stress image; the
# reverse's re-image and its transposes
IMAGE_OPS = {"forward": 2, "reverse": 6}


def passes(shape, order: int, pml: int, nt: int, nsrc: int, nrec: int, tape, reverse: bool):
    """{pass: (flops a step, bytes a step, bytes a shot)} of one marine shot:
    its forward and, with ``reverse``, its reverse; ``nrec`` hydrophones,
    one pressure each a step."""
    r = order // 2
    S = pml + r
    NX = shape[1] + 2 * S
    out = {}
    for name, (flops, step_b, shot_b) in counts_elastic.passes(
            shape, order, pml, nt, nsrc, nrec, tape, reverse).items():
        flops += IMAGE_OPS[name] * r * NX - STRIP_OPS[name] * S * NX
        out[name] = (flops, step_b, shot_b)
    return out


def shot_bound_s(shape, order: int, pml: int, nt: int, nsrc: int, nrec: int, tape,
                 reverse: bool) -> float:
    """Least seconds one marine shot can take on the card: its passes one
    after another, each at the larger of its operations and bytes bound."""
    return sum(nt * step_bound_s(c, nt)[0]
               for c in passes(shape, order, pml, nt, nsrc, nrec, tape, reverse).values())
