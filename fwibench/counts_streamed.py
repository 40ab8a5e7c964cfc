"""Operations and bytes of one acoustic shot, as ``counts.passes`` gives
them, with a 2D pass's fields counted as streamed from device memory where
they outgrow the card's L2.

``counts.py`` holds a 2D field of the grid in the card's 50 MB L2, so that
its 2D passes move only their receivers, sources and tape row a step. That
holds while the fields a pass reads and writes a step fit there: its bytes
at each padded cell, and 16 B at each CPML strip cell (the strip memories,
as the 3D count has them). Where those bytes exceed the L2, the pass moves
them every step, on top of what ``counts.passes`` gives it a step:

- forward: 16 B a padded cell (P_t, P_{t-1} and C in; P_{t+1} out);
- rings reverse: 36 B a cell (P_t, P_{t-1}, lambda_{t+1}, lambda_t, C and
  gbar in; P_{t-2}, lambda_{t-1} and gbar out);
- snapshot reverse: 24 B a cell (lambda_{t+1}, lambda_t, C and gbar in;
  lambda_{t-1} and gbar out).

Otherwise the pass keeps ``counts.passes``' figures. Under this rule:

- every 2D cell on the 10 m grid (399 x 1749 padded) keeps them, bit for
  bit: its fields take 11 MB a step in the forward and 25 MB in the rings
  reverse, plus 1.6 MB of strips;
- on the 5 m grid (749 x 3449 padded) the forward's fields stay in L2 at
  41 MB a step (45 MB with the strips);
- the 5 m rings reverse's 93 MB (96 MB with the strips) stream.

3D passes stream in ``counts.passes`` already and are returned unchanged.
"""

from __future__ import annotations

from fwibench import counts

L2_BYTES = 50 * 2**20  # NVIDIA H100: 50 MiB of L2
STRIP_BYTES = 16
CELL_BYTES = {"forward": 16, "rings": 36, "snapshot": 24}


def field_bytes(shape, order: int, pml: int, pass_: str, tape) -> int:
    """Bytes of the fields a 2D pass (``"forward"`` or ``"reverse"``, with
    ``tape`` (kind, dtype)) reads and writes a step."""
    _, S, (NZ, NX) = counts._geometry(shape, order, pml)
    per_cell = CELL_BYTES["forward" if pass_ == "forward" else tape[0]]
    return per_cell * NZ * NX + STRIP_BYTES * 2 * S * (NZ + NX)


def passes(shape, order: int, pml: int, nt: int, nsrc: int, nrec: int, tape,
           reverse: bool):
    """``counts.passes``, each 2D pass whose fields outgrow the L2 moving
    them every step (the module's rule)."""
    out = counts.passes(shape, order, pml, nt, nsrc, nrec, tape, reverse)
    if len(shape) != 2:
        return out
    for name, (flops, per_step, per_shot) in out.items():
        fields = field_bytes(shape, order, pml, name, tape)
        if fields > L2_BYTES:
            out[name] = (flops, per_step + fields, per_shot)
    return out


def shot_bound_s(shape, order: int, pml: int, nt: int, nsrc: int, nrec: int, tape,
                 reverse: bool) -> float:
    """Least seconds one shot can take on the card: its passes (``passes``)
    one after another, each at the larger of its operations and bytes
    bound."""
    return sum(nt * counts.step_bound_s(c, nt)[0]
               for c in passes(shape, order, pml, nt, nsrc, nrec, tape, reverse).values())
