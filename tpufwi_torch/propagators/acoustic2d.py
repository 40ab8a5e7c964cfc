"""User-facing 2D acoustic propagator (counterpart of
``tpufwi/propagators/acoustic2d.py``).

Engines:
- ``"eager"``: the exact boundary-saving adjoint in plain torch
  (``adjoint.make_simulator``), on the CPU, fp32 or fp64; the counterpart of
  the reference's ``'jnp'`` engine. ``tape_dtype`` is its option only.
- ``"cuda_scansnap"``: the whole-scan CUDA engine with the bf16 snapshot
  tape (two sweeps per gradient, nt * NZ * NX * 2 bytes of tape).
- ``"cuda_scanres"``: the whole-scan CUDA engine with the fp32 ring tape
  (three sweeps, the field reconstructed backwards).
- ``"cuda_step"``: the single-step CUDA engine, one kernel call per step
  from Python; explicit only, as the reference's ``'pallas'``.

``impl="auto"`` resolves from the propagator's ``device``, ``dtype`` and
grid: "eager" on the CPU; on CUDA "cuda_scansnap" when its tape fits the
card's budget, else "cuda_scanres", with the reason in ``resolve_note``.
It raises where no ported engine fits (3D grids, fp64 on CUDA).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..cpml import build_profiles
from ..grid import Grid, pad_model
from ..kernels.acoustic2d_eager import AcousticParams, make_acoustic_step, zero_state

ENGINES = ("eager", "cuda_scansnap", "cuda_scanres", "cuda_step")


class AcousticPropagator:
    """Constant-density acoustic propagator with CPML.

    Usage:
        prop = AcousticPropagator(grid, dt, f0, c_max)   # on the card
        seis = prop(vp, geom, wavelet)   # differentiable in vp and wavelet
    """

    # Share of the card's memory the snapshot tapes may take, sized for two
    # shots' tapes alive at once (the next shot's forward may start before
    # the last backward's tape is released); the rest holds the model,
    # data, fields and workspace.
    SNAP_TAPE_SHARE = 0.8
    SNAP_TAPES_IN_FLIGHT = 2

    def __init__(
        self,
        grid: Grid,
        dt: float,
        f0: float,
        c_max: float,
        dtype=torch.float32,
        impl: str = "auto",
        device="cuda",
        tape_dtype=None,
    ):
        grid.check_dt(dt, c_max)
        if impl not in ("auto",) + ENGINES:
            raise ValueError(f"unknown impl {impl!r}; choose from auto, {', '.join(ENGINES)}")
        self.grid = grid
        self.dt = float(dt)
        self.f0 = float(f0)
        self.c_max = float(c_max)
        self.dtype = dtype
        self.device = torch.device(device)
        self.impl = impl
        self._tape_dtype = tape_dtype
        # account of the engine choice, logged into the driver JSONL
        self.resolve_note = "explicit" if impl != "auto" else "unresolved"
        if impl != "auto":
            self._check_engine(impl)
        self._profiles = build_profiles(grid, dt, c_max, f0, dtype=np.float64)
        self._step = make_acoustic_step(grid)
        self._sims = {}

    # -- engine selection ----------------------------------------------------

    def _check_engine(self, impl: str) -> None:
        if self.grid.ndim != 2:
            raise NotImplementedError(
                f"{self.grid.ndim}D grid: only the 2D acoustic engines are "
                "ported (3D kernels: ROADMAP Queue B items 12-18)"
            )
        if impl == "eager":
            if self.device.type != "cpu":
                raise ValueError("the eager engine runs in plain torch on the CPU")
            return
        if self.device.type != "cuda":
            raise ValueError(f"{impl} needs a CUDA device")
        if self.dtype != torch.float32:
            raise ValueError(
                f"{self.dtype} on CUDA: the CUDA engines are fp32 only "
                "(run fp64 on the CPU eager engine)"
            )
        if self._tape_dtype is not None:
            raise ValueError("tape_dtype is an eager-engine option")

    def snap_tape_budget_bytes(self) -> int:
        """Bytes one shot's bf16 snapshot tape may take on this card."""
        total = torch.cuda.get_device_properties(self.device).total_memory
        return int(self.SNAP_TAPE_SHARE * total) // self.SNAP_TAPES_IN_FLIGHT

    def resolve_impl(self, nt: int | None = None) -> str:
        """The engine a call with a length-``nt`` wavelet will use. For
        impl='auto': "eager" on the CPU; on CUDA "cuda_scansnap" when the
        grid is 2D fp32 and its snapshot tape fits the card's budget, else
        the rings engine "cuda_scanres". Every other case raises with the
        reason."""
        if self.impl != "auto":
            self._check_engine(self.impl)
            return self.impl
        if self.device.type == "cpu":
            self._check_engine("eager")
            impl, self.resolve_note = "eager", "auto: CPU tensor -> exact eager engine"
        else:
            self._check_engine("cuda_scansnap")
            NZ, NX = self.grid.padded_shape
            budget = self.snap_tape_budget_bytes()
            if nt is None:
                reason = "wavelet length unknown (snapshot tape cannot be sized)"
            elif nt * NZ * NX * 2 > budget:
                reason = (f"bf16 snapshot tape {nt * NZ * NX * 2 / 2**30:.1f} GiB exceeds the "
                          f"{budget / 2**30:.1f} GiB budget of this card")
            else:
                reason = None
            if reason is None:
                impl, self.resolve_note = "cuda_scansnap", "auto: CUDA snapshot engine"
            else:
                impl = "cuda_scanres"
                self.resolve_note = f"auto: CUDA rings engine (snapshot ineligible: {reason})"
        logging.getLogger(__name__).info("impl='auto' -> %s (%s)", impl, self.resolve_note)
        return impl

    def fix_impl_for(self, nt: int | None = None) -> str:
        """Resolve impl='auto' once for a wavelet length and pin it."""
        self.impl = self.resolve_impl(nt=nt)
        return self.impl

    def _sim(self, impl: str):
        if impl not in self._sims:
            if impl == "eager":
                from ..adjoint import make_simulator

                sim = make_simulator(self.grid, self.dt, self.f0, self.c_max,
                                     tape_dtype=self._tape_dtype)
            elif impl == "cuda_step":
                from ..adjoint_step import make_simulator_step

                sim = make_simulator_step(self.grid, self.dt, self.f0, self.c_max)
            else:
                from ..adjoint_scanres import make_simulator_scanres

                sim = make_simulator_scanres(
                    self.grid, self.dt, self.f0, self.c_max,
                    tape_mode="snap" if impl == "cuda_scansnap" else "rings")
            self._sims[impl] = sim
        return self._sims[impl]

    # -- model prep ----------------------------------------------------------

    def c2dt2(self, vp: torch.Tensor) -> torch.Tensor:
        """Differentiable map: physical vp -> padded (c*dt)^2."""
        return (pad_model(vp.to(self.dtype), self.grid) * self.dt) ** 2

    # -- public entry points -------------------------------------------------

    def __call__(self, vp: torch.Tensor, geom, wavelet: torch.Tensor) -> torch.Tensor:
        """Seismogram (nt, nrec), differentiable in vp and wavelet."""
        impl = self.resolve_impl(nt=int(wavelet.shape[0]))
        return self._sim(impl)(
            self.c2dt2(vp), wavelet.to(self.dtype), geom.src_idx, geom.rcv_idx
        )

    def _twin_loop(self, vp, geom, wavelet):
        """Yield the state after each step of the plain step twin on the
        propagator's device."""
        a, b = (tuple(torch.as_tensor(p[i], dtype=self.dtype, device=self.device)
                      for p in self._profiles) for i in (0, 1))
        params = AcousticParams(
            c2dt2=self.c2dt2(vp), a=a, b=b, src_idx=geom.src_idx, rcv_idx=geom.rcv_idx,
        )
        state = zero_state(self.grid.padded_shape, self.grid.ndim, self.dtype, self.device)
        for w_t in wavelet.to(self.dtype):
            state, rec = self._step(state, params, w_t)
            yield state, rec

    @torch.no_grad()
    def forward_snapshots(self, vp, geom, wavelet, stride: int = 1):
        """Non-differentiable forward that also returns the interior
        wavefield every ``stride`` steps: (seis (nt, nrec), snaps)."""
        interior = self.grid.interior
        seis, snaps = [], []
        for t, (state, rec) in enumerate(self._twin_loop(vp, geom, wavelet)):
            seis.append(rec)
            if t % stride == 0:
                snaps.append(state.p[interior])
        return torch.stack(seis), torch.stack(snaps)

    @torch.no_grad()
    def illumination(self, vp, geom, wavelet):
        """Source illumination sum_t p_t^2 on the physical grid (the
        pseudo-Hessian diagonal for preconditioning). A plain torch loop of
        the step twin on the propagator's device: no engine kernel computes
        it yet (ROADMAP Queue C)."""
        interior = self.grid.interior
        illum = torch.zeros(self.grid.shape, dtype=self.dtype, device=self.device)
        for state, _ in self._twin_loop(vp, geom, wavelet):
            illum += state.p[interior] ** 2
        return illum

    @torch.no_grad()
    def wavefield_energy(self, vp, geom, wavelet):
        """Interior energy sum p_t^2 per step (CPML efficacy diagnostics)."""
        interior = self.grid.interior
        return torch.stack([(state.p[interior] ** 2).sum()
                            for state, _ in self._twin_loop(vp, geom, wavelet)])
