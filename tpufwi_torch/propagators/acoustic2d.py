"""User-facing 2D and 3D acoustic propagator (counterpart of
``tpufwi/propagators/acoustic2d.py``).

Engines:
- ``"eager"``: the exact boundary-saving adjoint in plain torch
  (``adjoint.make_simulator``), on the CPU, fp32 or fp64, 2D or 3D; the
  counterpart of the reference's ``'jnp'`` engine. ``tape_dtype`` is its
  option only.
- ``"cuda_scansnap"``: the whole-scan CUDA engine with the bf16 snapshot
  tape (two sweeps per gradient, nt * NZ * NX * 2 bytes of tape).
- ``"cuda_scanres"``: the whole-scan CUDA engine with the fp32 ring tape
  (three sweeps, the field reconstructed backwards).
- ``"cuda_step"``: the single-step CUDA engine, one kernel call per step
  from Python; explicit only, as the reference's ``'pallas'``. Its option
  ``merged_reverse`` makes each reverse step one call of the merged
  reverse kernel instead of two. The two-call form stays the default for
  two reasons: it is the reference the merged step is held against, and
  it is the main path that runs ``recon_step`` and
  ``fused_adjoint_step``. The merged form gives the same gradient in
  fewer calls.
- ``"cuda_kstep"``: the K-step CUDA engine (``adjoint_kstep``), K = 4
  steps per cooperative kernel call; explicit only (the reference has no
  impl name for its K-step engine).
- ``"cuda3d"`` / ``"cuda3d_bf16"``: the fused 3D engine
  (``adjoint3d.make_simulator3d``) with an fp32 or bf16 ring tape, the
  reference's ``'pallas3d'`` / ``'pallas3d_bf16'``; 3D grids only.

The reference's engine names (``REFERENCE_IMPLS``: ``'jnp'``,
``'pallas'``, ``'pallas_scanres'``, ...) select their counterparts, and
``resolve_note`` records the mapping.

``impl="auto"`` resolves from the propagator's ``device``, ``dtype`` and
grid: "eager" on the CPU; on CUDA in 2D "cuda_scansnap" when its tape fits
the card's budget, else "cuda_scanres"; in 3D "cuda3d" when one shot's fp32
ring tape fits the card's budget, else "cuda3d_bf16" when the bf16 tape
does; the reason goes to ``resolve_note``. It raises where no ported engine
fits (a 3D tape over budget, fp64 on CUDA): it never falls back to a slow
engine.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .. import profiling
from ..cpml import build_profiles
from ..grid import Grid, pad_model
from ..kernels.acoustic2d_eager import AcousticParams, make_acoustic_step, zero_state
from .boundary import RingSpec, tape_budget_bytes

ENGINES_2D = ("cuda_scansnap", "cuda_scanres", "cuda_step", "cuda_kstep")
ENGINES_3D = ("cuda3d", "cuda3d_bf16")
ENGINES = ("eager",) + ENGINES_2D + ENGINES_3D
# the reference's impl names (tpufwi/propagators/acoustic2d.py) -> the port's
REFERENCE_IMPLS = {"jnp": "eager", "pallas_scansnap": "cuda_scansnap",
                   "pallas_scanres": "cuda_scanres", "pallas": "cuda_step",
                   "pallas3d": "cuda3d", "pallas3d_bf16": "cuda3d_bf16"}


def reference_impl(impl: str, table) -> tuple:
    """(the port's engine, resolve_note) for an impl name that may be the
    reference's."""
    if impl in table:
        return table[impl], f"{impl} -> {table[impl]}"
    return impl, ("explicit" if impl != "auto" else "unresolved")


class AcousticPropagator:
    """Constant-density acoustic propagator with CPML.

    Usage:
        prop = AcousticPropagator(grid, dt, f0, c_max)   # on the card
        seis = prop(vp, geom, wavelet)   # differentiable in vp and wavelet
    """

    # (share of the card's memory, shots' tapes alive at once) of each
    # tape's budget (boundary.tape_budget_bytes); the rest of the card holds
    # the model, the data, the engine's fields and workspace. Snapshot
    # tapes (2D): two in flight, since the next shot's forward may start
    # before the last backward's tape is released. 3D ring tapes: one, since
    # the host shot loop releases a shot's tape when its backward ends; the
    # other 30% holds 7.9 GiB of fields, CPML strips and data beside the
    # 41.8 GiB bf16 tape of one shot on the full SEG/EAGE Overthrust grid
    # (147.8 M cells) on an 80 GB card.
    SNAP_TAPE_BUDGET = (0.8, 2)
    TAPE3D_BUDGET = (0.7, 1)

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
        merged_reverse: bool = False,
    ):
        grid.check_dt(dt, c_max)
        # account of the engine choice, logged in the inversion's JSONL records
        impl, self.resolve_note = reference_impl(impl, REFERENCE_IMPLS)
        if impl not in ("auto",) + ENGINES:
            raise ValueError(f"unknown impl {impl!r}; choose from auto, {', '.join(ENGINES)} "
                             f"or a reference name ({', '.join(REFERENCE_IMPLS)})")
        self.grid = grid
        self.dt = float(dt)
        self.f0 = float(f0)
        self.c_max = float(c_max)
        self.dtype = dtype
        self.device = torch.device(device)
        self.impl = impl
        self._tape_dtype = tape_dtype
        self._merged_reverse = bool(merged_reverse)
        if impl != "auto":
            self._check_engine(impl)
        self._profiles = build_profiles(grid, dt, c_max, f0, dtype=np.float64)
        self._step = make_acoustic_step(grid)
        self._sims = {}

    # -- engine selection ----------------------------------------------------

    def _check_engine(self, impl: str) -> None:
        if self.grid.ndim not in (2, 3):
            raise NotImplementedError(f"{self.grid.ndim}D grid: the engines are 2D or 3D")
        if impl in ENGINES_3D and self.grid.ndim != 3:
            raise ValueError(f"{impl} is the 3D engine; the grid is 2D")
        if impl in ENGINES_2D and self.grid.ndim != 2:
            raise ValueError(f"{impl} is a 2D engine; on a 3D grid use cuda3d or cuda3d_bf16")
        if self._merged_reverse and impl != "cuda_step":
            raise ValueError("merged_reverse is a cuda_step option")
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
        return tape_budget_bytes(self.device, *self.SNAP_TAPE_BUDGET)

    def tape3d_budget_bytes(self) -> int:
        """Bytes one shot's 3D ring tape may take on this card."""
        return tape_budget_bytes(self.device, *self.TAPE3D_BUDGET)

    def tape3d_bytes(self, nt: int, dtype_bytes: int = 4) -> int:
        """One shot's 3D ring tape: nt rows of the ring cells."""
        return nt * RingSpec.build(self.grid).tape_bytes_per_step(dtype_bytes)

    def _resolve_3d(self, nt: int | None) -> str:
        """'auto' on the card for a 3D grid: the fp32 tape when it fits the
        budget, else the bf16 tape, else raise with the reason."""
        self._check_engine("cuda3d")
        budget = self.tape3d_budget_bytes()
        if nt is None:
            reason = "the wavelet length is unknown, so the ring tape cannot be sized"
        elif self.tape3d_bytes(nt, 4) <= budget:
            self.resolve_note = (f"auto: CUDA 3D engine, fp32 ring tape "
                                 f"{self.tape3d_bytes(nt, 4) / 2**30:.1f} GiB")
            return "cuda3d"
        elif self.tape3d_bytes(nt, 2) <= budget:
            self.resolve_note = (f"auto: CUDA 3D engine, bf16 ring tape "
                                 f"{self.tape3d_bytes(nt, 2) / 2**30:.1f} GiB (fp32 tape "
                                 f"{self.tape3d_bytes(nt, 4) / 2**30:.1f} GiB over the "
                                 f"{budget / 2**30:.1f} GiB budget)")
            return "cuda3d_bf16"
        else:
            reason = (f"the bf16 ring tape {self.tape3d_bytes(nt, 2) / 2**30:.1f} GiB exceeds "
                      f"the {budget / 2**30:.1f} GiB budget of this card")
        raise NotImplementedError(
            f"3D grid: no ported engine fits: {reason} (the checkpointed gradient and the "
            "domain-sharded engine are not ported; reference: tpufwi/propagators/remat.py, "
            "tpufwi/propagators/acoustic3d.py)")

    def resolve_impl(self, nt: int | None = None) -> str:
        """The engine a call with a length-``nt`` wavelet will use. For
        impl='auto': "eager" on the CPU; on CUDA in 2D "cuda_scansnap" when
        the grid is fp32 and its snapshot tape fits the card's budget, else
        the rings engine "cuda_scanres"; in 3D "cuda3d" when the fp32 ring
        tape fits, else "cuda3d_bf16" when the bf16 tape does. Every other
        case raises with the reason."""
        if self.impl != "auto":
            self._check_engine(self.impl)
            return self.impl
        if self.device.type == "cpu":
            self._check_engine("eager")
            impl, self.resolve_note = "eager", "auto: CPU tensor -> exact eager engine"
        elif self.grid.ndim == 3:
            impl = self._resolve_3d(nt)
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
            elif impl in ENGINES_3D:
                from ..adjoint3d import make_simulator3d

                sim = make_simulator3d(
                    self.grid, self.dt, self.f0, self.c_max,
                    tape_dtype=torch.bfloat16 if impl == "cuda3d_bf16" else None)
            elif impl == "cuda_step":
                from ..adjoint_step import make_simulator_step

                sim = make_simulator_step(self.grid, self.dt, self.f0, self.c_max,
                                          merged_reverse=self._merged_reverse)
            elif impl == "cuda_kstep":
                from ..adjoint_kstep import make_simulator_kstep

                sim = make_simulator_kstep(self.grid, self.dt, self.f0, self.c_max)
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
        with profiling.span("propagator.call", engine=impl):
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
        pseudo-Hessian diagonal for preconditioning). Every CUDA engine
        computes it in its forward kernel (``simulate.illumination``); an
        engine on the card without one raises. The CPU engine ``eager``
        runs a plain torch loop of the step twin."""
        impl = self.resolve_impl(nt=int(wavelet.shape[0]))
        fused = getattr(self._sim(impl), "illumination", None)
        if fused is not None:
            return fused(self.c2dt2(vp), wavelet.to(self.dtype), geom.src_idx)
        if self.device.type != "cpu":
            raise NotImplementedError(
                f"engine {impl} has no illumination kernel; the plain step twin runs on the "
                "CPU only")
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
