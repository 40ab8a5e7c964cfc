"""User-facing 2D acoustic propagator (counterpart of
``tpufwi/propagators/acoustic2d.py``).

Engines: ``"eager"``, the plain torch versions of the scanres kernels on
the CPU, and ``"cuda_scansnap"``, the CUDA snapshot engine. Both sit
behind one ``simulate`` (``adjoint_scanres``): its kernel wrappers take
the plain path exactly for CPU tensors. ``impl="auto"`` resolves from the
propagator's ``device``, ``dtype`` and grid, and raises with the reason
where no ported engine fits instead of falling back.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..cpml import build_profiles
from ..grid import Grid, pad_model
from ..kernels.acoustic2d_eager import AcousticParams, make_acoustic_step, zero_state

ENGINES = ("eager", "cuda_scansnap")


class AcousticPropagator:
    """Constant-density acoustic propagator with CPML.

    Usage:
        prop = AcousticPropagator(grid, dt, f0, c_max, device="cuda")
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
        device="cpu",
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
        # account of the engine choice, logged into the driver JSONL
        self.resolve_note = "explicit" if impl != "auto" else "unresolved"
        if impl != "auto":
            self._check_engine(impl)
        self._profiles = build_profiles(grid, dt, c_max, f0, dtype=np.float64)
        self._step = make_acoustic_step(grid)
        self._simulate = None

    # -- engine selection ----------------------------------------------------

    def _check_engine(self, impl: str) -> None:
        if self.grid.ndim != 2:
            raise NotImplementedError(
                f"{self.grid.ndim}D grid: only the 2D acoustic engines are "
                "ported (3D kernels: ROADMAP Queue B items 12-18)"
            )
        if impl == "eager" and self.device.type != "cpu":
            raise ValueError("the eager engine runs the plain versions on the CPU")
        if impl == "cuda_scansnap":
            if self.device.type != "cuda":
                raise ValueError("cuda_scansnap needs a CUDA device")
            if self.dtype != torch.float32:
                raise ValueError(
                    f"{self.dtype} on CUDA: the CUDA engine is fp32 only "
                    "(run fp64 on the CPU eager engine)"
                )

    def snap_tape_budget_bytes(self) -> int:
        """Bytes one shot's bf16 snapshot tape may take on this card."""
        total = torch.cuda.get_device_properties(self.device).total_memory
        return int(self.SNAP_TAPE_SHARE * total) // self.SNAP_TAPES_IN_FLIGHT

    def resolve_impl(self, nt: int | None = None) -> str:
        """The engine a call with a length-``nt`` wavelet will use. For
        impl='auto': a CPU device gives "eager", a CUDA device "cuda_scansnap"
        when the grid is 2D fp32 and the tape fits the card's budget. Every
        other case raises with the reason."""
        auto = self.impl == "auto"
        impl = self.impl if not auto else (
            "eager" if self.device.type == "cpu" else "cuda_scansnap")
        self._check_engine(impl)
        if impl == "cuda_scansnap":
            if nt is None:
                raise ValueError("wavelet length unknown: the snapshot tape cannot be sized")
            NZ, NX = self.grid.padded_shape
            tape = nt * NZ * NX * 2
            budget = self.snap_tape_budget_bytes()
            if tape > budget:
                raise NotImplementedError(
                    f"bf16 snapshot tape {tape / 2**30:.1f} GiB exceeds the "
                    f"{budget / 2**30:.1f} GiB budget of this card; the rings "
                    "reverse that runs without it (make_scanres_reverse) is "
                    "not ported yet (ROADMAP Queue B)"
                )
        if auto:
            self.resolve_note = ("auto: CPU tensor -> plain engine" if impl == "eager"
                                 else "auto: CUDA snapshot engine")
            logging.getLogger(__name__).info("impl='auto' -> %s", impl)
        return impl

    def fix_impl_for(self, nt: int | None = None) -> str:
        """Resolve impl='auto' once for a wavelet length and pin it."""
        self.impl = self.resolve_impl(nt=nt)
        return self.impl

    def _sim(self):
        if self._simulate is None:
            from ..adjoint_scanres import make_simulator_scanres

            self._simulate = make_simulator_scanres(self.grid, self.dt, self.f0, self.c_max)
        return self._simulate

    # -- model prep ----------------------------------------------------------

    def c2dt2(self, vp: torch.Tensor) -> torch.Tensor:
        """Differentiable map: physical vp -> padded (c*dt)^2."""
        return (pad_model(vp.to(self.dtype), self.grid) * self.dt) ** 2

    # -- public entry points -------------------------------------------------

    def __call__(self, vp: torch.Tensor, geom, wavelet: torch.Tensor) -> torch.Tensor:
        """Seismogram (nt, nrec), differentiable in vp and wavelet."""
        self.resolve_impl(nt=int(wavelet.shape[0]))
        return self._sim()(
            self.c2dt2(vp), wavelet.to(self.dtype), geom.src_idx, geom.rcv_idx
        )

    @torch.no_grad()
    def illumination(self, vp, geom, wavelet):
        """Source illumination sum_t p_t^2 on the physical grid (the
        pseudo-Hessian diagonal for preconditioning). A plain torch loop of
        the step twin on the propagator's device: no engine kernel computes
        it yet (ROADMAP Queue C)."""
        a, b = (tuple(torch.as_tensor(p[i], dtype=self.dtype, device=self.device)
                      for p in self._profiles) for i in (0, 1))
        params = AcousticParams(
            c2dt2=self.c2dt2(vp), a=a, b=b, src_idx=geom.src_idx, rcv_idx=geom.rcv_idx,
        )
        interior = self.grid.interior
        state = zero_state(self.grid.padded_shape, self.grid.ndim, self.dtype, self.device)
        illum = torch.zeros(self.grid.shape, dtype=self.dtype, device=self.device)
        for w_t in wavelet.to(self.dtype):
            state, _ = self._step(state, params, w_t)
            illum += state.p[interior] ** 2
        return illum
