"""The per-step elastic engine's four kernels: CUDA wrappers, their plain
torch versions and their launch counters (counterpart of
``tpufwi/kernels/elastic2d_pallas.py::make_elastic_fused_step`` and
``tpufwi/kernels/elastic2d_pallas_bwd.py::make_elastic_bwd_kernels``), and
the tape-free forward ``make_elastic_forward_fused`` (the counterpart of
``make_pallas_elastic_forward``).

Each call runs one stage of one time step and updates the caller's state in
place:

- ``estep_v``: stage V (the four stress-derivative CPML memories, vx, vz),
  then the mid-step velocity image;
- ``estep_s``: stage S (the four velocity-derivative memories, sxx, szz,
  sxz), the step's sources, the stress image, ``seis[t]`` and, when given,
  ``ring_row`` <- the five fields' rings;
- ``estep_rs``: the receiver-cotangent injection of ``ybar[t]``, the
  stress-image transpose, ``srcrow[t]`` <- the source-point cotangent and
  the source undone on the primal; sigma_t reconstructed, the stress rings
  of ``ring_row`` (tape row t-1; zeros when None) imposed and re-imaged;
  imaging of lam, lam2mu, mu_xz; the transposed stress update; the
  velocity-image transpose;
- ``estep_rv``: v_{t-1/2} reconstructed, the velocity rings of
  ``ring_row`` imposed and re-imaged; imaging of buoy_x, buoy_z; the
  transposed velocity update.

The state is the port's own layout, as the whole-scan kernels keep it, not
the TPU kernels' strip-only memories and flattened ring slabs:
``ElasticStepState`` (forward) and ``ElasticReverseState``. A force source
is undone once, on the primal vz, at the start of ``estep_rs``; the
reference's two reverse kernels each undo it on a local copy of vz, so
between the two calls the reference's carried vz still holds the source
and the port's does not. After ``estep_rv`` the two agree.

The plain versions run ``make_elastic_step``'s stages and
``make_elastic_reverse_stages`` (``kernels/elastic2d_scan.py``) on views
of the same tensors. The CUDA source is ``csrc/elastic2d_step.cu``, built
into the elastic library. Each wrapper takes its plain version for CPU
tensors only; on a CUDA tensor it launches the kernel or raises, and counts
one launch per call. The per-call checks skip the index bounds (one host
sync): ``estep_forward`` and the reverse loop check those once per
propagation.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..adjoint_scanres import profile_source
from .acoustic2d_scanres import require_cuda, ring_plan, strip_depth, surface_row
from .build import raise_on
from .elastic2d_eager import check_kinds, make_elastic_step
from .elastic2d_scan import (
    _check,
    _flags,
    _params,
    load_library,
    make_elastic_reverse_stages,
    taps_arg,
)

_taps = functools.lru_cache(maxsize=None)(taps_arg)


class ElasticStepState(NamedTuple):
    """The forward state: ``fields`` (5, NZ + 2R, NX + 2R), vx, vz, sxx,
    szz, sxz with a zero halo of R cells that no kernel writes; ``mem`` (8,
    NZ, NX), the CPML memories of stage V (m_sxx_x, m_sxz_z, m_sxz_x,
    m_szz_z) then of stage S (m_vx_x, m_vz_z, m_vx_z, m_vz_x), zero outside
    the strips."""

    fields: torch.Tensor
    mem: torch.Tensor


class ElasticReverseState(NamedTuple):
    """The reverse state: ``fields`` as the forward's; ``cot`` (5, NZ, NX)
    their cotangents; ``dual`` (8, NZ, NX) the memories' cotangents, R-S's
    four (stage S's memories) then R-V's four (stage V's); ``grads`` (5, NZ,
    NX) the lam, lam2mu, mu_xz, buoy_x, buoy_z accumulators; ``q`` (4, NZ +
    2R, NX + 2R) the kernels' zero-halo scratch (unused by the plain
    versions)."""

    fields: torch.Tensor
    cot: torch.Tensor
    dual: torch.Tensor
    grads: torch.Tensor
    q: torch.Tensor


def _halo(grid):
    NZ, NX = grid.padded_shape
    return NZ + 2 * grid.radius, NX + 2 * grid.radius


def zero_elastic_step_state(grid, dtype=torch.float32, device="cuda") -> ElasticStepState:
    new = dict(dtype=dtype, device=device)
    return ElasticStepState(torch.zeros((5, *_halo(grid)), **new),
                            torch.zeros((8, *grid.padded_shape), **new))


def zero_elastic_reverse_state(grid, dtype=torch.float32, device="cuda") -> ElasticReverseState:
    new = dict(dtype=dtype, device=device)
    compact = grid.padded_shape
    return ElasticReverseState(torch.zeros((5, *_halo(grid)), **new),
                               torch.zeros((5, *compact), **new),
                               torch.zeros((8, *compact), **new),
                               torch.zeros((5, *compact), **new),
                               torch.zeros((4, *_halo(grid)), **new))


def inner(grid, x):
    """The padded-grid interior of halo planes."""
    R = grid.radius
    return x[..., R:-R, R:-R]


def copy_into(dst, values):
    """Copy each of ``values`` into the tensor of ``dst`` at its place (a
    state into a state of the same layout)."""
    for d, v in zip(dst, values):
        d.copy_(v)


# ------------------------------------------------------------ plain versions


def estep_v_plain(grid, dt, mats, profiles, state):
    params = _params(grid, mats, profiles, None, None)
    f = inner(grid, state.fields)
    vx, vz, mem_v = make_elastic_step(grid, dt).stage_v(*f, tuple(state.mem[:4]), params, None)
    copy_into(f[:2], (vx, vz))
    copy_into(state.mem[:4], mem_v)


def estep_s_plain(grid, dt, mats, profiles, state, wavelet, t, src_idx, rcv_idx, seis,
                  ring_row=None, source_type="pressure", record="v"):
    params = _params(grid, mats, profiles, src_idx, rcv_idx)
    step = make_elastic_step(grid, dt, source_type, record)
    f = inner(grid, state.fields)
    vz, sxx, szz, sxz, mem_s, rec = step.stage_s(*f, tuple(state.mem[4:]), params, wavelet[t])
    copy_into(f[1:], (vz, sxx, szz, sxz))
    copy_into(state.mem[4:], mem_s)
    seis[t] = rec
    if ring_row is not None:
        idx = ring_plan(grid, mats[0].device)[0]
        ring_row.copy_(torch.cat([x.reshape(-1)[idx] for x in f]))


def estep_rs_plain(grid, dt, mats, profiles, state, wavelet, ybar, t, src_idx, rcv_idx, srcrow,
                   ring_row=None, source_type="pressure", record="v"):
    params = _params(grid, mats, profiles, src_idx, rcv_idx)
    rev_s, _ = make_elastic_reverse_stages(grid, dt, source_type, record)
    f = inner(grid, state.fields)
    fields, cot, dual, g3, srcrow[t] = rev_s(
        params, tuple(f), tuple(state.cot), tuple(state.dual[:4]), tuple(state.grads[:3]),
        wavelet[t], ybar[t], ring_row, ring_plan(grid, mats[0].device)[0])
    copy_into(f, fields)
    copy_into(state.cot, cot)
    copy_into(state.dual[:4], dual)
    copy_into(state.grads[:3], g3)


def estep_rv_plain(grid, dt, mats, profiles, state, ring_row=None):
    params = _params(grid, mats, profiles, None, None)
    _, rev_v = make_elastic_reverse_stages(grid, dt)
    f = inner(grid, state.fields)
    fields, cot, dual, g2 = rev_v(params, tuple(f), tuple(state.cot), tuple(state.dual[4:]),
                                  tuple(state.grads[3:]), ring_row,
                                  ring_plan(grid, mats[0].device)[0])
    copy_into(f, fields)
    copy_into(state.cot, cot)
    copy_into(state.dual[4:], dual)
    copy_into(state.grads[3:], g2)


# ---------------------------------------------------------------- wrappers


def _check_call(name, grid, mats, profiles, state, vectors=()):
    """What every call's kernels need (no host sync): a 2D grid of a
    supported order, the state's shapes, and contiguous fp32 tensors on one
    card."""
    require_cuda(name, mats[0])
    if grid.ndim != 2 or grid.radius not in (1, 2, 4):
        raise ValueError(f"{name}: 2D grids of order 2, 4 or 8 only")
    dev = mats[0].device
    for x in (*mats, *profiles, *state, *vectors):
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name}: float tensors must be contiguous fp32 on {dev}")
    compact, halo = tuple(grid.padded_shape), _halo(grid)
    S = strip_depth(grid)
    if (any(tuple(m.shape) != compact for m in mats) or len(mats) != 5
            or any(p.numel() != 2 * S for p in profiles) or len(profiles) != 4):
        raise ValueError(f"{name}: five material fields {compact} and four strip profiles "
                         f"of 2 x {S} expected")
    want = {"fields": (5, *halo), "mem": (8, *compact), "cot": (5, *compact),
            "dual": (8, *compact), "grads": (5, *compact), "q": (4, *halo)}
    for key, x in zip(state._fields, state):
        if tuple(x.shape) != want[key]:
            raise ValueError(f"{name}: state.{key} must be {want[key]}")


def _check_indices(name, dev, src_idx, rcv_idx):
    for idx in (src_idx, rcv_idx):
        if (idx.device != dev or idx.dtype != torch.int64 or not idx.is_contiguous()
                or idx.ndim != 2 or idx.shape[1] != 2 or idx.shape[0] < 1):
            raise ValueError(f"{name}: indices must be contiguous (n>0, 2) int64 on {dev}")


def _ring_arg(name, grid, dev, ring_row):
    """(int32 ring cells, n_ring, the row's pointer) with the row checked."""
    ring = ring_plan(grid, dev)[1]
    n = ring.shape[0]
    if ring_row is None:
        return ring, n, None
    if (tuple(ring_row.shape) != (5 * n,) or ring_row.dtype != torch.float32
            or ring_row.device != dev or not ring_row.is_contiguous()):
        raise ValueError(f"{name}: ring_row must be contiguous fp32 ({5 * n},) on {dev}")
    return ring, n, ring_row.data_ptr()


def _seis_shape(nt, nrec, record):
    return (nt, nrec, 2) if record == "v" else (nt, nrec)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def estep_v(grid, dt, mats, profiles, state):
    """Stage V of one step and the velocity image, in place on ``state``
    (an ``ElasticStepState``)."""
    if mats[0].device.type == "cpu":
        return estep_v_plain(grid, dt, mats, profiles, state)
    _check_call("estep_v", grid, mats, profiles, state)
    lib = load_library()
    NZ, NX = grid.padded_shape
    err = lib.tpufwi_estep_v(
        *(m.data_ptr() for m in mats), *(p.data_ptr() for p in profiles),
        state.fields.data_ptr(), state.mem.data_ptr(), NZ, NX, strip_depth(grid), grid.radius,
        surface_row(grid), _taps(grid, dt), _stream(mats[0].device))
    raise_on(lib, "estep_v", err)
    estep_v.launches += 1


estep_v.launches = 0


def estep_s(grid, dt, mats, profiles, state, wavelet, t, src_idx, rcv_idx, seis, ring_row=None,
            source_type="pressure", record="v"):
    """Stage S of step ``t``, its sources, the stress image, ``seis[t]``
    and ``ring_row`` (when given), in place (see the module docstring)."""
    if mats[0].device.type == "cpu":
        return estep_s_plain(grid, dt, mats, profiles, state, wavelet, t, src_idx, rcv_idx,
                             seis, ring_row, source_type, record)
    check_kinds(source_type, record)
    _check_call("estep_s", grid, mats, profiles, state, (wavelet, seis))
    dev = mats[0].device
    _check_indices("estep_s", dev, src_idx, rcv_idx)
    nt, nrec = wavelet.shape[0], rcv_idx.shape[0]
    if tuple(seis.shape) != _seis_shape(nt, nrec, record) or not 0 <= t < nt:
        raise ValueError(f"estep_s: seis must be {_seis_shape(nt, nrec, record)}, t < {nt}")
    ring, n_ring, row = _ring_arg("estep_s", grid, dev, ring_row)
    lib = load_library()
    NZ, NX = grid.padded_shape
    fs, force, rec_v = _flags(grid, source_type, record)
    err = lib.tpufwi_estep_s(
        *(m.data_ptr() for m in mats), *(p.data_ptr() for p in profiles), wavelet.data_ptr(),
        src_idx.data_ptr(), rcv_idx.data_ptr(), seis.data_ptr(), ring.data_ptr(), row,
        state.fields.data_ptr(), state.mem.data_ptr(), t, NZ, NX, strip_depth(grid),
        grid.radius, src_idx.shape[0], nrec, fs, n_ring, force, rec_v, _taps(grid, dt),
        _stream(dev))
    raise_on(lib, "estep_s", err)
    estep_s.launches += 1


estep_s.launches = 0


def estep_rs(grid, dt, mats, profiles, state, wavelet, ybar, t, src_idx, rcv_idx, srcrow,
             ring_row=None, source_type="pressure", record="v", chain=None, init_chain=False):
    """The first half of reverse step ``t`` in place on ``state`` (an
    ``ElasticReverseState``; see the module docstring). On CUDA, ``chain``
    (2 * nrec int32) orders coinciding receivers; ``init_chain`` builds it,
    on the first reverse step."""
    if mats[0].device.type == "cpu":
        return estep_rs_plain(grid, dt, mats, profiles, state, wavelet, ybar, t, src_idx,
                              rcv_idx, srcrow, ring_row, source_type, record)
    check_kinds(source_type, record)
    _check_call("estep_rs", grid, mats, profiles, state, (wavelet, ybar, srcrow))
    dev = mats[0].device
    _check_indices("estep_rs", dev, src_idx, rcv_idx)
    nt, nrec, nsrc = wavelet.shape[0], rcv_idx.shape[0], src_idx.shape[0]
    if (tuple(ybar.shape) != _seis_shape(nt, nrec, record)
            or tuple(srcrow.shape) != (nt, nsrc) or not 0 <= t < nt):
        raise ValueError(f"estep_rs: ybar must be {_seis_shape(nt, nrec, record)}, srcrow "
                         f"({nt}, {nsrc}), t < {nt}")
    if (chain is None or chain.dtype != torch.int32 or chain.numel() != 2 * nrec
            or chain.device != dev):
        raise ValueError("estep_rs: chain must be 2 * nrec int32 on the card")
    ring, n_ring, row = _ring_arg("estep_rs", grid, dev, ring_row)
    lib = load_library()
    NZ, NX = grid.padded_shape
    fs, force, rec_v = _flags(grid, source_type, record)
    err = lib.tpufwi_estep_rs(
        *(m.data_ptr() for m in mats), *(p.data_ptr() for p in profiles), wavelet.data_ptr(),
        ybar.data_ptr(), src_idx.data_ptr(), rcv_idx.data_ptr(), chain.data_ptr(),
        srcrow.data_ptr(), ring.data_ptr(), row, *(x.data_ptr() for x in (
            state.fields, state.q, state.cot, state.dual, state.grads)),
        t, int(init_chain), NZ, NX, strip_depth(grid), grid.radius, nsrc, nrec, fs, n_ring,
        force, rec_v, _taps(grid, dt), _stream(dev))
    raise_on(lib, "estep_rs", err)
    estep_rs.launches += 1


estep_rs.launches = 0


def estep_rv(grid, dt, mats, profiles, state, ring_row=None):
    """The second half of a reverse step in place on ``state`` (see the
    module docstring); ``ring_row`` as ``estep_rs``'s."""
    if mats[0].device.type == "cpu":
        return estep_rv_plain(grid, dt, mats, profiles, state, ring_row)
    _check_call("estep_rv", grid, mats, profiles, state)
    dev = mats[0].device
    ring, n_ring, row = _ring_arg("estep_rv", grid, dev, ring_row)
    lib = load_library()
    NZ, NX = grid.padded_shape
    err = lib.tpufwi_estep_rv(
        *(m.data_ptr() for m in mats), *(p.data_ptr() for p in profiles), ring.data_ptr(), row,
        *(x.data_ptr() for x in (state.fields, state.q, state.cot, state.dual, state.grads)),
        NZ, NX, strip_depth(grid), grid.radius, surface_row(grid), n_ring, _taps(grid, dt),
        _stream(dev))
    raise_on(lib, "estep_rv", err)
    estep_rv.launches += 1


estep_rv.launches = 0


# ------------------------------------------------------------------ forward


def estep_forward(grid, dt, mats, profiles, wavelet, src_idx, rcv_idx, source_type="pressure",
                  record="v", tape=False):
    """The per-step forward loop, with ``escan_forward``'s contract:
    (seis, tape or None, the five final fields), ``estep_v`` and
    ``estep_s`` once per step. On CPU tensors the plain versions run."""
    dev, dtype = mats[0].device, mats[0].dtype
    if dev.type == "cuda":  # index bounds: one host sync per propagation
        _check("estep_forward", grid, mats, profiles, (wavelet,), src_idx, rcv_idx,
               source_type, record)
    nt = wavelet.shape[0]
    state = zero_elastic_step_state(grid, dtype, dev)
    seis = torch.empty(_seis_shape(nt, rcv_idx.shape[0], record), dtype=dtype, device=dev)
    n_ring = ring_plan(grid, dev)[0].shape[0]
    rows = torch.empty((nt, 5 * n_ring), dtype=dtype, device=dev) if tape else None
    for t in range(nt):
        estep_v(grid, dt, mats, profiles, state)
        estep_s(grid, dt, mats, profiles, state, wavelet, t, src_idx, rcv_idx, seis,
                None if rows is None else rows[t], source_type, record)
    return seis, rows, tuple(inner(grid, state.fields))


def make_elastic_forward_fused(grid, dt, f0, c_max, source_type="pressure", record="v"):
    """``simulate(mats, wavelet, src_idx, rcv_idx) -> seis``: the tape-free
    forward on the per-step kernels (the counterpart of the reference's
    ``make_pallas_elastic_forward``), ``mats`` the five padded material
    fields. Not differentiable."""
    profiles_for = profile_source(grid, dt, f0, c_max)

    @torch.no_grad()
    def simulate(mats, wavelet, src_idx, rcv_idx):
        mats = tuple(m.contiguous() for m in mats)
        return estep_forward(grid, dt, mats, profiles_for(mats[0]), wavelet.contiguous(),
                             src_idx.contiguous(), rcv_idx.contiguous(), source_type,
                             record)[0]

    return simulate
