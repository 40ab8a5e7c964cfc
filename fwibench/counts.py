"""Operations and bytes of one shot, as the algorithm needs them, and the
least time the card could take for them.

A pure function of the shot's shapes: the padded grid, the order and CPML
width, nt, the sources and receivers, the tape the configuration states,
and whether the shot runs the reverse. Each input is read once and each
output written once; a whole-scan pass's once-a-shot inputs and outputs
are spread over its nt steps. The arithmetic is the port's own
(``chip_smoke.py`` ``step_counts`` and ``a3d_step_counts``), copied here so
that the count stays the same whatever engine does the work:

- 2D: a field of the grid fits the card's 50 MB L2, so a step moves only
  its receivers, sources and tape row; the fields, the model and the
  gradient move once a shot.
- 3D: a field outgrows the card's on-chip memory, so every step moves the
  fields it reads and writes (forward 16 B a cell, reverse 36 B a cell,
  16 B a CPML strip cell).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet, at 700 W
FP32_FLOPS_PER_S = 67e12  # outside the tensor cores
F = 4  # fp32 bytes
TAPE_BYTES = {"float32": 4, "bfloat16": 2}


def ring_cells(shape, r: int) -> int:
    """Cells of the width-r frame just inside the physical grid, tiled by
    onion peeling as the ring tapes hold them."""
    n = 0
    for d in range(len(shape)):
        face = 1
        for i, s in enumerate(shape):
            if i != d:
                face *= s - 2 * r if i < d else s
        n += 2 * r * face
    return n


def _geometry(shape, order: int, pml: int):
    r = order // 2
    S = pml + r
    padded = tuple(s + 2 * S for s in shape)
    return r, S, padded


def passes(shape, order: int, pml: int, nt: int, nsrc: int, nrec: int, tape,
           reverse: bool):
    """{pass: (flops a step, bytes a step, bytes a shot)} of one shot: its
    forward and, with ``reverse``, its reverse. ``tape``: None (no tape) or
    (kind, dtype): "snapshot" (a 2D D2-laplacian row a step) or "rings"
    (the frame a step), in "float32" or "bfloat16"."""
    if tape is not None:
        tape, tape_dtype = tape
    r, S, padded = _geometry(shape, order, pml)
    taps = 2 * r + 1
    n_ring = ring_cells(shape, r)
    if len(shape) == 2:
        NZ, NX = padded
        cells, strips, ext = NZ * NX, 2 * S * (NX + NZ), 2 * (S + r) * (NX + NZ)
        fwd = cells * (4 * taps + 4) + strips * (2 * taps + 8) + ext * (2 * taps + 1) + 2 * nsrc
        rev = cells * (4 * taps + 6) + strips * (3 * taps + 6) + ext * 4 * taps + 2 * nsrc
        recon = cells * (4 * taps + 4) + 2 * nsrc
        if tape is None:
            out = {"forward": (fwd, nrec * F, 3 * cells * F)}
        elif tape == "snapshot":
            row = cells * TAPE_BYTES[tape_dtype]
            out = {"forward": (fwd, nrec * F + row, 3 * cells * F),
                   "reverse": (rev, nrec * F + nsrc * F + row, 2 * cells * F)}
        else:
            row = n_ring * TAPE_BYTES[tape_dtype]
            out = {"forward": (fwd, nrec * F + row, 3 * cells * F),
                   "reverse": (rev + recon, nrec * F + nsrc * F + row, 4 * cells * F)}
    else:
        NY, NZ, NX = padded
        faces = NZ * NX + NY * NX + NY * NZ
        cells, strips, ext = NY * NZ * NX, 2 * S * faces, 2 * (S + r) * faces
        fwd = cells * (6 * taps + 4) + strips * (2 * taps + 8) + ext * (2 * taps + 1) + 2 * nsrc
        rev = cells * (10 * taps + 12) + strips * (4 * taps + 6) + ext * 4 * taps + 2 * nsrc
        if tape is None:
            out = {"forward": (fwd, 16 * cells + 16 * strips + nrec * F, 3 * cells * F)}
        elif tape == "rings":
            row = n_ring * TAPE_BYTES[tape_dtype]
            out = {"forward": (fwd, 16 * cells + 16 * strips + nrec * F + row, 3 * cells * F),
                   "reverse": (rev, 36 * cells + 16 * strips + (nrec + nsrc) * F + row,
                               3 * cells * F)}
        else:
            raise ValueError(f"3D tape {tape!r}: the 3D engines keep a ring tape")
    if not reverse:
        out.pop("reverse", None)
    return out


def step_bound_s(counts, nt: int) -> tuple[float, str]:
    """(least seconds a step, "operations" or "bytes") of one pass."""
    flops, per_step, per_shot = counts
    t_ops = flops / FP32_FLOPS_PER_S
    t_bytes = (per_step + per_shot / nt) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def shot_bound_s(shape, order: int, pml: int, nt: int, nsrc: int, nrec: int, tape,
                 reverse: bool) -> float:
    """Least seconds one shot can take on the card: its passes one after
    another, each at the larger of its operations and bytes bound."""
    return sum(nt * step_bound_s(c, nt)[0]
               for c in passes(shape, order, pml, nt, nsrc, nrec, tape, reverse).values())
