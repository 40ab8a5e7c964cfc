"""Spans and counters of the port (counterpart of ``tpufwi/profiling.py``).

Spans mark the layer boundaries of the graded path, outermost first
(name: where; *device* spans also time the device; attributes):

- ``objective.evaluation``: ``FwiProblem.stage_objectives``' ``vg`` and
  ``loss`` (and the multiparameter problems'); kind ("grad" or "loss"),
  shots.
- ``objective.shot``, *device*: each shot of their host loop; shot.
- ``propagator.call``: ``AcousticPropagator`` / ``ElasticPropagator``
  ``__call__``; engine.
- ``engine.forward`` / ``engine.reverse``: the whole-scan engines' forward
  (with and without grad) and backward.
- ``propagator.materials``, *device*: ``ElasticPropagator.__call__``'s map
  from (vp, vs, rho) to the padded staggered materials (elastic only).
- ``engine.finish``, *device*: the elastic engines' ``finish_elastic_gradient``
  inside ``engine.reverse`` (the force's buoy_z term, the wavelet's cotangent,
  the valid-region mask; elastic only).
- ``kernels.forward`` / ``kernels.reverse``, *device*: the C entry-point
  call alone of each whole-scan wrapper; wrapper, nt, tape_bytes (the tape
  it allocated), for the 3D wrappers variant, for the elastic ones
  free_surface, and for the 2D acoustic ones what a count of the pass
  needs: the padded grid NZ and NX, radius, strip (the CPML strip depth),
  nsrc, nrec and tape (the tape mode: None, "snap" or "rings").

Each recorded span holds its name, host start and end, its parent span,
the evaluation it belongs to (the ``objective.evaluation`` span that
encloses it, shared by every span of one objective call), its attributes
and the counters' values at its start and end. A device span also records
a ``torch.cuda.Event`` pair on the stream current at its start; read
``Span.device_s`` only after the caller's own synchronize, since the
program adds none.

Spans record while a ``torch.profiler`` records, or inside
``recording()``. Otherwise ``span`` returns a shared no-op after one flag
check: no record, no event, no profiler range. While the profiler records,
a span also enters its host timeline as a range of a kind that leaves no
copy on the device timeline, so that idle gaps of the device are named by
the innermost span around them. Spans nest by time across the process:
the autograd engine runs a CUDA backward on a thread of its own while the
calling thread waits inside the shot's span, so one stack serves both.
Records accumulate until ``clear()``.

Counters are process-wide integer adds, always on (as the kernel
wrappers' ``.launches``, which stay the kernels' step counters):

- ``host_syncs``: each place on the graded path where the program waits
  on the device (the kernel wrappers' index checks);
- ``grad_shots``, ``loss_shots``: shots run by the objectives' ``vg`` and
  ``loss``;
- ``a3d_shell_tiled_cells``: the CPML shell's cells x nt of each
  ``a3d_forward`` / ``a3d_reverse`` call that marched them in shared-memory
  tiles (the default variant; 0 under ``variant="gather"``);
- ``a3d_tcpml_cells``: the transposed CPML terms x nt that the line pass of
  each ``a3d_reverse`` call on the card wrote (every cell within S + R of a
  face, once an axis; both variants run the line pass);
- ``escan_image_steps``: the steps of each ``escan_reverse`` call on a
  grid with the free surface, on each of which the images run, folded
  into the surface tile row of ``er_s`` and ``er_v``; the call's one image
  launch (``er_image_s_t``, the first step's stress-image transpose) is
  the only ``er_image`` kernel left.

``trace(run_dir, label)`` profiles a block into a Chrome/Perfetto trace
with the spans in it. ``roofline_report`` of the reference is not ported:
it runs ``bench_stencil``, a stencil timing the port's benchmark
(``fwibench/``) does not carry; its ``shot_roofline_pct`` is the share a
user pays by.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

SPANS = ("objective.evaluation", "objective.shot", "propagator.call", "engine.forward",
         "engine.reverse", "kernels.forward", "kernels.reverse", "propagator.materials",
         "engine.finish")
COUNTERS = ("host_syncs", "grad_shots", "loss_shots", "a3d_shell_tiled_cells",
            "a3d_tcpml_cells", "escan_image_steps")

# a profiler range with no device-side twin (a user annotation gets one)
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)


@dataclasses.dataclass(eq=False)
class Span:
    """One recorded span; ``t0_ns`` / ``t1_ns`` on ``time.perf_counter_ns``."""

    name: str
    id: int
    parent: Optional[int]
    evaluation: Optional[int]
    attrs: dict
    t0_ns: int
    counters0: dict
    t1_ns: Optional[int] = None
    counters1: Optional[dict] = None
    events: Optional[tuple] = None  # (start, end) CUDA events of a device span

    @property
    def device_s(self) -> Optional[float]:
        """Seconds between the span's CUDA events (None for a host span, or
        one on the CPU). Read after a synchronize."""
        if self.events is None:
            return None
        return self.events[0].elapsed_time(self.events[1]) * 1e-3

    def delta(self, counter: str) -> int:
        """The counter's change over the span."""
        return self.counters1[counter] - self.counters0[counter]


class _State:
    def __init__(self):
        self.recording = 0  # depth of recording() blocks
        self.spans = []  # finished spans, in the order they ended
        self.open = []  # the spans open now, outermost first
        self.ids = 0
        self.counters = dict.fromkeys(COUNTERS, 0)


_state = _State()


def on() -> bool:
    """Whether spans record now."""
    return bool(_state.recording) or _autograd_profiler._is_profiler_enabled


def count(name: str, n: int = 1) -> None:
    _state.counters[name] += n


def counters() -> dict:
    """The counters' values now."""
    return dict(_state.counters)


def spans() -> list:
    """The finished spans recorded so far, in the order they ended."""
    return list(_state.spans)


def clear() -> None:
    """Drop the finished spans (the counters keep counting)."""
    _state.spans.clear()


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with no profiler."""
    _state.recording += 1
    try:
        yield
    finally:
        _state.recording -= 1


class _Off:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Live:
    """The context of one recorded span."""

    __slots__ = ("name", "device", "attrs", "span", "range", "stream")

    def __init__(self, name, device, attrs):
        if name not in SPANS:
            raise ValueError(f"unknown span {name!r}; the spans are {SPANS}")
        self.name, self.device, self.attrs = name, device, attrs
        self.span = self.range = self.stream = None

    def __enter__(self) -> Span:
        st = _state
        if _RANGE is not None and _autograd_profiler._is_profiler_enabled:
            self.range = _RANGE(self.name)
            self.range.__enter__()
        outer = st.open[-1] if st.open else None
        sid = st.ids
        st.ids += 1
        evaluation = sid if self.name == "objective.evaluation" else (
            outer.evaluation if outer is not None else None)
        s = Span(self.name, sid, None if outer is None else outer.id, evaluation, self.attrs,
                 time.perf_counter_ns(), dict(st.counters))
        if self.device is not None and torch.device(self.device).type == "cuda":
            self.stream = torch.cuda.current_stream(self.device)
            s.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            s.events[0].record(self.stream)
        st.open.append(s)
        self.span = s
        return s

    def __exit__(self, *exc):
        st, s = _state, self.span
        if s.events is not None:
            s.events[1].record(self.stream)
        s.t1_ns = time.perf_counter_ns()
        s.counters1 = dict(st.counters)
        if st.open and st.open[-1] is s:
            st.open.pop()
        else:  # closed out of order: another thread's span is on top
            st.open.remove(s)
        st.spans.append(s)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, device=None, **attrs):
    """``with span(name, device=d, **attrs):`` records the block as one of
    ``SPANS`` while spans record (``on()``), with a CUDA event pair on
    ``d``'s current stream when ``d`` is a CUDA device; otherwise a no-op."""
    if not on():
        return _OFF
    return _Live(name, device, attrs)


@contextlib.contextmanager
def trace(run_dir: str, label: str = "trace"):
    """Profile a block into ``<run_dir>/profile/<label>/trace.json``, a
    Chrome/Perfetto trace holding the spans as host ranges:
    ``with profiling.trace(run_dir): J, g = vg(vp); torch.cuda.synchronize()``.
    Synchronize inside the block, or the device work after the last
    launch falls outside it. Yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    out = os.path.join(run_dir, "profile", label)
    os.makedirs(out, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(out, "trace.json")
    prof.export_chrome_trace(path)
    print(f"[tpufwi_torch] trace written to {path}")
