"""Elastic P-SV propagator and its Vp/Vs/rho adjoint gradients (counterpart
of ``tpufwi/propagators/elastic2d.py``).

The engines share one architecture: a forward time loop that records the
five-field boundary-ring tape, and a boundary-saving reverse that
reconstructs the fields backwards (the staggered leapfrog is
time-reversible in the lossless interior; the rings are re-imposed every
reverse step) while it runs the exact transposed step. Gradients come out
with respect to the padded, staggered material fields (lam, lam+2mu,
mu_xz, buoyancy at the velocity points) and chain to Vp/Vs/rho through the
differentiable ``material_fields`` outside the engine.

Engines:
- ``"eager"``: the plain torch loop (``make_elastic_simulator``), on the
  CPU, fp32 or fp64; the counterpart of the reference's ``'jnp'`` engine.
- ``"cuda_escan"``: the whole-scan CUDA engine
  (``adjoint_elastic_scan.make_elastic_simulator_scan``), fp32 on a card;
  the counterpart of ``'pallas_scan'``.
- ``"cuda_estep"``: the per-step engine
  (``adjoint_elastic_step.make_elastic_simulator_fused``), four CUDA
  kernels called once per time step from a Python loop, fp32 on a card;
  the counterpart of ``'pallas'``. ``forward_fused`` runs its tape-free
  forward.

The reference's engine names (``REFERENCE_IMPLS``) select their
counterparts, and ``resolve_note`` records the mapping.

``impl="auto"`` resolves from the propagator's device: "eager" on the CPU,
"cuda_escan" on CUDA, where it raises when one shot's ring tape exceeds
the card's budget (the reference has no such guard). It never picks
"cuda_estep": the reference falls back to its per-step engine when a
shot's receivers span more than its whole-scan engine's 16-row slab, and
the port's whole-scan kernels gather receivers by index, with no slab. 3D
grids and fp64 on CUDA raise with the reason.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .. import profiling
from ..adjoint_scanres import profile_source
from ..cpml import build_profiles
from ..grid import D1_STAGGERED_COEFFS, Grid, pad_model
from ..kernels.elastic2d_eager import (
    FIELDS,
    ElasticParams,
    check_kinds,
    make_elastic_step,
    zero_elastic_state,
)
from ..kernels.elastic2d_scan import escan_forward_plain, escan_reverse_plain
from ..kernels.elastic2d_step import make_elastic_forward_fused
from .acoustic2d import reference_impl
from .boundary import RingSpec, tape_budget_bytes

ENGINES = ("eager", "cuda_escan", "cuda_estep")
# the reference's impl names (tpufwi/propagators/elastic2d.py) -> the port's
REFERENCE_IMPLS = {"jnp": "eager", "pallas_scan": "cuda_escan", "pallas": "cuda_estep"}


def elastic_cfl_dt(h, vp_max: float, order: int = 4, safety: float = 0.8) -> float:
    """Staggered-grid stability bound dt <= h / (sqrt(2) vp_max sum|c|)
    (Levander 1988) for square cells (general: harmonic in 1/h^2)."""
    cs = np.abs(np.asarray(D1_STAGGERED_COEFFS[order])).sum()
    if np.isscalar(h):
        h = [float(h)] * 2
    denom = vp_max * cs * np.sqrt(sum(1.0 / hd**2 for hd in h))
    return float(safety / denom)


def _shift_edge(f: torch.Tensor, axis: int) -> torch.Tensor:
    """out[i] = f[i+1] with edge extension (material averaging)."""
    n = f.shape[axis]
    return torch.cat([f.narrow(axis, 1, n - 1), f.narrow(axis, n - 1, 1)], dim=axis)


def finish_elastic_gradient(rings: RingSpec, dt: float, grads, srcrow, buoy_z, wavelet,
                            src_idx, source_type: str):
    """(material cotangents, wavelet cotangent) from a reverse's five
    unmasked cotangents and its source-point row: the wavelet cotangent,
    for a force source the buoy_z term of the injection dt buoy_z[src] w,
    then the valid-region mask."""
    sz, sx = src_idx[:, 0], src_idx[:, 1]
    grads = list(grads)
    if source_type == "pressure":
        wbar = dt * srcrow.sum(1)
    else:
        wbar = dt * (srcrow * buoy_z[sz, sx][None, :]).sum(1)
        grads[4] = grads[4].index_put((sz, sx), dt * (srcrow * wavelet[:, None]).sum(0),
                                      accumulate=True)
    return tuple(rings.mask_valid(g) for g in grads), wbar


def make_elastic_function(grid: Grid, dt: float, f0: float, c_max: float, forward, reverse,
                          source_type: str = "pressure", record: str = "v"):
    """``simulate(lam, lam2mu, mu_xz, buoy_x, buoy_z, wavelet, src_idx,
    rcv_idx) -> seis``, a ``torch.autograd.Function`` over a forward with
    the ring tape and a boundary-saving reverse of the
    ``escan_forward`` / ``escan_reverse`` contract. Without grad the
    forward records no tape."""
    profiles_for = profile_source(grid, dt, f0, c_max)
    rings = RingSpec.build(grid)
    dt = float(dt)

    class Simulate(torch.autograd.Function):
        @staticmethod
        def forward(ctx, lam, l2m, muxz, bxm, bzm, wavelet, src_idx, rcv_idx):
            with profiling.span("engine.forward"):
                mats = (lam, l2m, muxz, bxm, bzm)
                seis, tape, finals = forward(grid, dt, mats, profiles_for(lam), wavelet,
                                             src_idx, rcv_idx, source_type, record, tape=True)
                ctx.save_for_backward(*mats, wavelet, src_idx, rcv_idx, tape, *finals)
                return seis

        @staticmethod
        def backward(ctx, seis_bar):
            with profiling.span("engine.reverse"):
                saved = ctx.saved_tensors
                mats, (wavelet, src_idx, rcv_idx, tape), finals = (saved[:5], saved[5:9],
                                                                   saved[9:])
                grads, srcrow = reverse(grid, dt, mats, profiles_for(mats[0]), wavelet,
                                        seis_bar.contiguous(), tape, finals, src_idx, rcv_idx,
                                        source_type, record)
                with profiling.span("engine.finish", device=mats[0].device):
                    grads, wbar = finish_elastic_gradient(rings, dt, grads, srcrow, mats[4],
                                                          wavelet, src_idx, source_type)
                return (*grads, wbar, None, None)

    def simulate(lam, l2m, muxz, bxm, bzm, wavelet, src_idx, rcv_idx):
        args = tuple(a.contiguous() for a in (lam, l2m, muxz, bxm, bzm, wavelet, src_idx,
                                               rcv_idx))
        if torch.is_grad_enabled() and any(a.requires_grad for a in args[:6]):
            return Simulate.apply(*args)
        mats, (wavelet, src_idx, rcv_idx) = args[:5], args[5:]
        with profiling.span("engine.forward"):
            return forward(grid, dt, mats, profiles_for(lam), wavelet, src_idx, rcv_idx,
                           source_type, record, tape=False)[0]

    return simulate


def make_elastic_simulator(grid: Grid, dt: float, f0: float, c_max: float,
                           source_type: str = "pressure", record: str = "v",
                           use_custom_vjp: bool = True):
    """The CPU engine ``"eager"``: ``simulate(lam, lam2mu, mu_xz, buoy_x,
    buoy_z, wavelet, src_idx, rcv_idx) -> seis``, differentiable in the five
    material fields and the wavelet by the exact boundary-saving adjoint
    (the plain versions of the whole-scan kernels). ``use_custom_vjp=False``
    gives plain autograd through the time loop instead (O(nt * grid)
    memory: the ground truth on tiny problems). Any float dtype; indices
    are grid-padded (nsrc, 2) and (nrec, 2)."""
    if use_custom_vjp:
        return make_elastic_function(grid, dt, f0, c_max, escan_forward_plain,
                                     escan_reverse_plain, source_type, record)
    profiles_for = profile_source(grid, dt, f0, c_max)

    def simulate_plain(lam, l2m, muxz, bxm, bzm, wavelet, src_idx, rcv_idx):
        return escan_forward_plain(grid, dt, (lam, l2m, muxz, bxm, bzm), profiles_for(lam),
                                   wavelet, src_idx, rcv_idx, source_type, record)[0]

    return simulate_plain


class ElasticPropagator:
    """User-facing elastic propagator: (vp, vs, rho) -> seismograms,
    differentiable in all three material fields.

    Usage:
        prop = ElasticPropagator(grid, dt, f0, vp_max, source_type="force_z")
        seis = prop(vp, vs, rho, geom, wavelet)  # (nt, nrec, 2) for record "v"

    Gradient validity: exact on the interior shrunk by radius+1 cells (one
    more than acoustic: the staggered material averaging chains each
    physical cell to staggered cotangents one cell away, and the staggered
    cotangent next to the boundary ring reads unreconstructible PML cells).
    """

    # (share of the card's memory, shots' tapes alive at once) of the ring
    # tape's budget, as AcousticPropagator's snapshot tapes.
    TAPE_BUDGET = (0.8, 2)

    def __init__(self, grid: Grid, dt: float, f0: float, vp_max: float, dtype=torch.float32,
                 source_type: str = "pressure", record: str = "v", impl: str = "auto",
                 device="cuda"):
        limit = elastic_cfl_dt(grid.h, vp_max, grid.order, safety=1.0)
        if dt > limit:
            raise ValueError(f"dt={dt:.6g} exceeds elastic CFL limit {limit:.6g}")
        # account of the engine choice, logged in the inversion's JSONL records
        impl, self.resolve_note = reference_impl(impl, REFERENCE_IMPLS)
        if impl not in ("auto",) + ENGINES:
            raise ValueError(f"unknown elastic impl {impl!r}; choose from auto, "
                             f"{', '.join(ENGINES)} or a reference name "
                             f"({', '.join(REFERENCE_IMPLS)})")
        check_kinds(source_type, record)
        self.grid = grid
        self.dt = float(dt)
        self.f0 = float(f0)
        self.vp_max = float(vp_max)
        self.dtype = dtype
        self.source_type = source_type
        self.record = record
        self.device = torch.device(device)
        self.impl = impl
        if impl != "auto":
            self._check_engine(impl)
        self._sims = {}
        self._fused = None

    # -- engine selection ----------------------------------------------------

    def _check_engine(self, impl: str) -> None:
        if self.grid.ndim != 2:
            raise NotImplementedError(
                f"{self.grid.ndim}D grid: the elastic engines are 2D (elastic 3D: "
                "not ported, reference: tpufwi/propagators/elastic3d.py)")
        if impl == "eager":
            if self.device.type != "cpu":
                raise ValueError("the eager engine runs in plain torch on the CPU")
            return
        if self.device.type != "cuda":
            raise ValueError(f"{impl} needs a CUDA device")
        if self.dtype != torch.float32:
            raise ValueError(f"{self.dtype} on CUDA: the CUDA engines are fp32 only "
                             "(run fp64 on the CPU eager engine)")

    def tape_bytes(self, nt: int) -> int:
        """Bytes of one shot's fp32 five-field ring tape."""
        return RingSpec.build(self.grid).tape_bytes_per_step(4) * 5 * int(nt)

    def tape_budget_bytes(self) -> int:
        """Bytes one shot's ring tape may take on this card."""
        return tape_budget_bytes(self.device, *self.TAPE_BUDGET)

    def resolve_impl(self, geom=None, nt: int | None = None) -> str:
        """The engine a call with a length-``nt`` wavelet will use. The port
        gathers receivers by index, so ``geom`` does not enter (no receiver
        slab), and 'auto' never picks "cuda_estep" (the reference's fallback
        for receivers beyond its scan slab). For impl='auto': "eager" on the
        CPU; "cuda_escan" on CUDA when one shot's ring tape fits the card's
        budget; every other case raises with the reason."""
        if self.impl != "auto":
            self._check_engine(self.impl)
            return self.impl
        if self.device.type == "cpu":
            self._check_engine("eager")
            impl, self.resolve_note = "eager", "auto: CPU tensor -> exact eager engine"
        else:
            self._check_engine("cuda_escan")
            impl = "cuda_escan"
            if nt is None:
                self.resolve_note = "auto: CUDA whole-scan engine (tape not sized: nt unknown)"
            else:
                tape, budget = self.tape_bytes(nt), self.tape_budget_bytes()
                if tape > budget:
                    raise ValueError(
                        f"elastic ring tape {tape / 2**30:.1f} GiB exceeds the "
                        f"{budget / 2**30:.1f} GiB budget of this card (nt={nt}); no "
                        "elastic engine with a smaller tape is ported")
                self.resolve_note = (f"auto: CUDA whole-scan engine (ring tape "
                                     f"{tape / 2**30:.2f} GiB)")
        logging.getLogger(__name__).info("elastic impl='auto' -> %s (%s)", impl,
                                         self.resolve_note)
        return impl

    def fix_impl_for(self, geom=None, nt: int | None = None) -> str:
        """Resolve impl='auto' once for a survey and pin it."""
        self.impl = self.resolve_impl(geom, nt=nt)
        return self.impl

    def _sim(self, impl: str):
        if impl not in self._sims:
            args = (self.grid, self.dt, self.f0, self.vp_max)
            kw = dict(source_type=self.source_type, record=self.record)
            if impl == "eager":
                sim = make_elastic_simulator(*args, **kw)
            elif impl == "cuda_escan":
                from ..adjoint_elastic_scan import make_elastic_simulator_scan

                sim = make_elastic_simulator_scan(*args, **kw)
            else:
                from ..adjoint_elastic_step import make_elastic_simulator_fused

                sim = make_elastic_simulator_fused(*args, **kw)
            self._sims[impl] = sim
        return self._sims[impl]

    # -- model prep ----------------------------------------------------------

    def material_fields(self, vp, vs, rho):
        """Differentiable map to the padded, staggered material fields
        (lam, lam2mu, mu_xz, buoy_x, buoy_z)."""
        vp_, vs_, rho_ = (pad_model(f.to(self.dtype), self.grid) for f in (vp, vs, rho))
        mu = rho_ * vs_**2
        lam = rho_ * vp_**2 - 2.0 * mu
        lam2mu = lam + 2.0 * mu
        mu_x = _shift_edge(mu, 1)
        mu_z = _shift_edge(mu, 0)
        mu_xz = 0.25 * (mu + mu_z + mu_x + _shift_edge(mu_z, 1))
        buoy = 1.0 / rho_
        buoy_x = 0.5 * (buoy + _shift_edge(buoy, 1))
        buoy_z = 0.5 * (buoy + _shift_edge(buoy, 0))
        return lam, lam2mu, mu_xz, buoy_x, buoy_z

    # -- public entry points -------------------------------------------------

    def __call__(self, vp, vs, rho, geom, wavelet):
        """Seismogram, (nt, nrec, 2) (vz, vx) for record "v" or (nt, nrec)
        pressure, differentiable in vp, vs, rho and the wavelet."""
        impl = self.resolve_impl(geom, nt=int(wavelet.shape[0]))
        with profiling.span("propagator.call", engine=impl):
            with profiling.span("propagator.materials", device=vp.device):
                mats = self.material_fields(vp, vs, rho)
            return self._sim(impl)(*mats, wavelet.to(self.dtype), geom.src_idx, geom.rcv_idx)

    @torch.no_grad()
    def forward_snapshots(self, vp, vs, rho, geom, wavelet, stride: int = 1,
                          field: str = "vz"):
        """Non-differentiable forward (the plain step twin on the
        propagator's device) that also returns interior snapshots of one
        component every ``stride`` steps: (seis, snaps). ``field``: one of
        vx, vz, sxx, szz, sxz, or "p" (= -(sxx+szz)/2)."""
        if field not in FIELDS + ("p",):
            raise ValueError(f"unknown field {field!r}")
        profs = build_profiles(self.grid, self.dt, self.vp_max, self.f0, dtype=np.float64)
        (az, bz), (ax, bx) = (
            tuple(torch.as_tensor(p, dtype=self.dtype, device=self.device) for p in prof[:2])
            for prof in profs)
        step = make_elastic_step(self.grid, self.dt, self.source_type, self.record)
        params = ElasticParams(*self.material_fields(vp, vs, rho), az=az, bz=bz, ax=ax, bx=bx,
                               src_idx=geom.src_idx, rcv_idx=geom.rcv_idx)
        interior = self.grid.interior
        state = zero_elastic_state(self.grid.padded_shape, self.dtype, self.device)
        seis, snaps = [], []
        for t, w_t in enumerate(wavelet.to(self.dtype)):
            state, rec = step(state, params, w_t)
            seis.append(rec)
            if t % stride == 0:
                f = (-(state.sxx + state.szz) / 2.0 if field == "p"
                     else getattr(state, field))
                snaps.append(f[interior])
        return torch.stack(seis), torch.stack(snaps)

    def forward_fused(self, vp, vs, rho, geom, wavelet):
        """The tape-free forward on the per-step kernels (the reference's
        fast forward for line-search and synthetic-data evaluations, TPU
        kernel 10): ``make_elastic_forward_fused`` on the propagator's
        device, the kernels on the card (fp32) and their plain versions on
        the CPU. Not differentiable; gradients go through ``__call__``."""
        if self.grid.ndim != 2:
            raise NotImplementedError(f"{self.grid.ndim}D grid: the elastic engines are 2D")
        if self.device.type == "cuda" and self.dtype != torch.float32:
            raise ValueError(f"{self.dtype} on CUDA: the per-step kernels are fp32 only")
        if self._fused is None:
            self._fused = make_elastic_forward_fused(self.grid, self.dt, self.f0, self.vp_max,
                                                     self.source_type, self.record)
        mats = self.material_fields(vp, vs, rho)
        return self._fused(mats, wavelet.to(self.dtype), geom.src_idx, geom.rcv_idx)
