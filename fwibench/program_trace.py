"""The program's own spans and counters (``tpufwi_torch.profiling``) as the
per-layer readers take them: in the benchmark's process, after the traced
evaluation and its synchronize. The program records spans while the
profiler of a ``--trace 1`` run records, so they are the traced
evaluation's. Each function gives None where the program recorded nothing
to read: a program without the module, or a run without a trace."""

from __future__ import annotations

KERNELS = ("kernels.forward", "kernels.reverse")


def records():
    """The program's finished spans, or None."""
    try:
        from tpufwi_torch import profiling
    except ImportError:
        return None
    return profiling.spans() or None


def named(spans, name) -> list:
    return [s for s in spans if s.name == name]


def below(spans, root, names) -> list:
    """The spans named in ``names`` that ``root`` encloses, at any depth."""
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    out, todo = [], list(kids.get(root.id, []))
    while todo:
        s = todo.pop()
        if s.name in names:
            out.append(s)
        todo.extend(kids.get(s.id, []))
    return out


def in_shots(spans, names) -> list:
    """The spans named in ``names`` inside the ``objective.shot`` spans."""
    return [k for shot in named(spans, "objective.shot") for k in below(spans, shot, names)]


def device_times(spans):
    """Each span's device seconds, or None if any span has none (a host
    span, or one on the CPU) or there is no span."""
    t = [s.device_s for s in spans]
    return None if not t or None in t else t


def us_per_step(name):
    """Device microseconds a time step of the ``name`` kernel spans inside
    the traced shots: their summed device time over their summed steps."""
    spans = records()
    if spans is None:
        return None
    ks = in_shots(spans, (name,))
    t = device_times(ks)
    if t is None:
        return None
    return 1e6 * sum(t) / sum(k.attrs["nt"] for k in ks)
