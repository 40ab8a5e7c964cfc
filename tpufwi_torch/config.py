"""Frozen-dataclass configuration tree, JSON-loadable, CLI-overridable.

Counterpart of ``tpufwi/config.py``, field for field, so a JSON config or a
list of overrides drives either package. Values the port does not run yet
(methods other than L-BFGS, Wolfe line search, physics other than
acoustic, ``pad_nt``) are rejected where they are used."""

from __future__ import annotations

import dataclasses
import json
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class StageCfg:
    """One frequency-continuation stage [GENRE: Bunks et al. 1995]."""

    fmax: float  # band edge in Hz; None = full band (final stage)
    iterations: int
    method: str = "lbfgs"  # or "nlcg"
    linesearch: str = "armijo"  # or "wolfe" (strong-Wolfe bracket+zoom)
    # re-estimate the source wavelet at stage start from the current model
    # (frequency-domain Wiener correction; source_estimation.py)
    source_est: bool = False
    # per-stage gradient smoothing radius (cells): multiscale runs smooth
    # more at the low bands (e.g. 2.0 -> 1.5 -> 1.0, the overthrust_ms
    # recipe); negative = inherit PrecondCfg.smooth_sigma
    smooth_sigma: float = -1.0


@dataclasses.dataclass(frozen=True)
class PropCfg:
    order: int = 8
    pml: int = 20
    cfl_safety: float = 0.7
    dtype: str = "float32"
    # engine: 'auto' (CPU -> 'eager'; CUDA -> 'cuda_scansnap' when its tape
    # fits the card, else 'cuda_scanres'), 'eager', 'cuda_scansnap',
    # 'cuda_scanres', 'cuda_step' or 'cuda_kstep', or a reference name
    # ('jnp', 'pallas', ...), which selects its counterpart
    # (tpufwi_torch.propagators.acoustic2d.REFERENCE_IMPLS)
    impl: str = "auto"


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    """Synthetic true-model size (io.marmousi_like arguments)."""

    nz: int = 176
    nx: int = 851
    dx: float = 10.0


@dataclasses.dataclass(frozen=True)
class AcqCfg:
    n_shots: int = 16
    src_z: int = 2
    rcv_z: int = 2
    rcv_dx: int = 2
    f0: float = 12.0
    t_max: float = 4.0


@dataclasses.dataclass(frozen=True)
class PrecondCfg:
    use_illumination: bool = True
    illum_eps: float = 1e-3
    depth_power: float = 0.0
    mask_top: int = 0
    smooth_sigma: float = 0.0


@dataclasses.dataclass(frozen=True)
class OptCfg:
    vmin: float = 1480.0
    vmax: float = 4700.0
    lbfgs_m: int = 10


@dataclasses.dataclass(frozen=True)
class RegCfg:
    """Model regularization (regularize.REGULARIZERS) added to every
    stage objective: J = J_data + weight * R(m)."""

    type: str = ""  # "", "tikhonov", "tv"
    weight: float = 0.0
    tv_eps: float = 1.0  # smoothing of the TV kink, in model units (m/s)


@dataclasses.dataclass(frozen=True)
class FwiConfig:
    stages: Tuple[StageCfg, ...] = (
        StageCfg(3.0, 12),
        StageCfg(5.0, 12),
        StageCfg(8.0, 13),
        StageCfg(12.0, 13),
    )
    prop: PropCfg = PropCfg()
    model: ModelCfg = ModelCfg()
    acq: AcqCfg = AcqCfg()
    precond: PrecondCfg = PrecondCfg()
    opt: OptCfg = OptCfg()
    reg: RegCfg = RegCfg()
    run_dir: str = "runs/default"
    mesh_shots: int = 0  # 0 = all devices on the shot axis
    checkpoint_every: int = 1
    # misfit functional (misfit.MISFITS): "l2", "normalized_l2", "envelope"
    misfit: str = "l2"
    # physics family driven by the CLI (invert.main): "acoustic" (vp FWI),
    # "elastic" (joint vp+vs P-SV FWI), "encoded" (random-polarity
    # simultaneous-source acoustic FWI, tpufwi.encoding)
    physics: str = "acoustic"
    # supershot realizations per gradient for physics="encoded"
    enc_realizations: int = 1
    # snap nt up to a multiple of this (0 = off) so nearby configs share
    # one compiled program / persistent-cache entry (window.canonical_nt;
    # applied by FwiProblem.with_canonical_nt for physics="acoustic")
    pad_nt: int = 0
    # wall-clock budget in seconds for the whole inversion (0 = unlimited).
    # When exceeded, the driver stops cleanly after the CURRENT iteration
    # (checkpoint written, stop event logged, remaining stages skipped) so
    # long runs under an external timeout always return a usable model
    # instead of being killed mid-step; resume=True continues them.
    max_wall_s: float = 0.0

    # -- (de)serialization ---------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "FwiConfig":
        raw = json.loads(text)
        return _from_dict(FwiConfig, raw)

    def with_overrides(self, overrides: List[str]) -> "FwiConfig":
        """Apply 'dotted.key=value' CLI overrides (e.g. prop.order=4)."""
        d = dataclasses.asdict(self)
        for ov in overrides:
            key, _, val = ov.partition("=")
            parts = key.split(".")
            node = d
            for p in parts[:-1]:
                node = node[p]
            old = node[parts[-1]]
            node[parts[-1]] = _coerce(val, old)
        return _from_dict(FwiConfig, d)


def _coerce(val: str, old):
    if isinstance(old, bool):
        return val.lower() in ("1", "true", "yes")
    if isinstance(old, int):
        return int(val)
    if isinstance(old, float):
        return float(val)
    if isinstance(old, (list, tuple)):
        return json.loads(val)
    return val


#: nested dataclass fields of FwiConfig (scalar fields pass through
#: generically — a new top-level scalar knob needs NO change here)
_NESTED = {
    "prop": PropCfg,
    "model": ModelCfg,
    "acq": AcqCfg,
    "precond": PrecondCfg,
    "opt": OptCfg,
    "reg": RegCfg,
}


def _from_dict(cls, raw):
    if cls is FwiConfig:
        stages = tuple(StageCfg(**s) for s in raw.get("stages", []))
        kw = {"stages": stages or FwiConfig().stages}
        for name, sub in _NESTED.items():
            kw[name] = sub(**raw.get(name, {}))
        for f in dataclasses.fields(FwiConfig):
            if f.name == "stages" or f.name in _NESTED:
                continue
            if f.name in raw:
                kw[f.name] = raw[f.name]
        return FwiConfig(**kw)
    raise TypeError(cls)
