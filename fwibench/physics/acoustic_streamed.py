"""The acoustic physics on a grid whose 2D passes outgrow the card's L2: a
configuration with ``"physics": "acoustic_streamed"`` runs here. The
inputs, the model, the program, the reference (``reference.py``) and the
misfit are ``physics/acoustic.py``'s; a shot's bound counts
``counts_streamed.py``, which moves such a pass's fields every step. The
program's engine is named as ``'auto'`` resolves it for the cell's nt, with
the reason. See ``spec.physics`` for what a physics provides.
"""

from __future__ import annotations

from fwibench import counts_streamed, harness, spec

acoustic = spec.find("physics", "acoustic")
Inputs, inputs, model = acoustic.Inputs, acoustic.inputs, acoustic.model
reference_outputs, misfit = acoustic.reference_outputs, acoustic.misfit


def program(cell: spec.Cell, inp: Inputs, device, split: dict) -> harness.Program:
    """``physics/acoustic.py``'s program, its engine named with the reason
    ``'auto'`` gave (the rings engine where the snapshot tape is over
    budget)."""
    prog = acoustic.program(cell, inp, device, split)
    prop = prog.tap.prop
    prog.engine = f"{prop.resolve_impl(nt=inp.nt)} ({prop.resolve_note})"
    return prog


def shot_bound_s(cell, inp: Inputs) -> float:
    """``counts_streamed.shot_bound_s`` of one shot of the cell."""
    return counts_streamed.shot_bound_s(cell.shape, cell.config["order"], cell.config["pml"],
                                        inp.nt, inp.src.shape[1], len(inp.rcv), cell.tape,
                                        cell.gradient)
