"""A cell of ``BENCHMARK.json`` and the files it names, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json``, ``checks/<cell>.json``,
``physics/<physics>.py``, ``layouts/<layout>.py`` and ``metrics/<metric>.py``;
and the survey geometry a configuration's layout describes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list
    physics: object  # the module ``physics`` finds for the configuration
    layout: object  # the module of the configuration's survey layout

    @property
    def shape(self) -> tuple:
        c = self.config
        return tuple(c[k] for k in ("ny", "nz", "nx") if k in c)

    @property
    def h(self) -> tuple:
        return (float(self.config["h_m"]),) * len(self.shape)

    @property
    def gradient(self) -> bool:
        return self.traffic["objective"] == "value_and_grad"

    @property
    def tape(self):
        """(kind, dtype) of the stated tape when the mix takes gradients."""
        return tuple(self.config["precision"]["tape"]) if self.gradient else None


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def metrics_for(entries, cell: str) -> list:
    return [m for m in entries if cell in m.get("workloads", [cell])]


def load_cell(name: str, bench: dict | None = None, base: Path = HERE) -> Cell:
    """The workload ``name`` of the checkout's ``BENCHMARK.json`` (or of
    ``bench``), its files found under ``base``."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    config = load_json(base / "configs" / f"{w['config']}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=load_json(base / "traffic" / f"{w['traffic']}.json"),
                check=load_json(base / "checks" / f"{name}.json"),
                end_to_end=metrics_for(bench["end_to_end"], name),
                per_layer=metrics_for(bench["per_layer"], name),
                physics=physics(config.get("physics", "acoustic"), base),
                layout=find("layouts", config["survey"]["layout"], base))


def load_module(name: str, path: Path):
    """The module at ``path``, loaded anew as ``name`` and entered in
    ``sys.modules`` (its dataclasses look themselves up there)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """``read(run)`` of ``metrics/<metric>.py``: the metric's value, or None
    where the run holds nothing to read it from."""
    return load_module(f"fwibench_metric_{metric}", HERE / "metrics" / f"{metric}.py").read


def physics(name: str, base: Path = HERE):
    """The module ``physics/<name>.py`` under ``base``, else under
    ``fwibench/``: everything the harness does that depends on the
    equations a configuration solves. It provides

    - ``inputs(cell, seed, device)``: the run's inputs made from the seed,
      an object with at least ``src`` (nshot, nsrc, ndim) and ``nt``;
    - ``model(cell, inputs, seed, e)``: evaluation e's model, a tuple of
      fields;
    - ``program(cell, inputs, device, split)``: the system under test set
      up and warmed, a ``harness.Program``, with the set-up's parts in
      seconds added to ``split``;
    - ``reference_outputs(cell, inputs, model, sample, device, dtype)``:
      the plain reference's (seismograms (k, nt, ...), J (k,), gradients
      (a (k, *shape) tensor per field of the model) or None) of the
      sampled shots, with fields of ``dtype``;
    - ``misfit(cell, inputs, seis, d_obs)``: the objective's J summed over
      the given shots' seismograms (k, nt, ...) against their observed data,
      on the device they are on;
    - ``shot_bound_s(cell, inputs)``: the least seconds a shot can take on
      the card.
    """
    return find("physics", name, base)


def find(kind: str, name: str, base: Path = HERE):
    """The module ``<kind>/<name>.py`` under ``base``, else under
    ``fwibench/``; a name that neither holds fails, naming it. A survey
    layout (``layouts/``) provides ``geometry(shape, survey)``: the sources
    (nshot, 1, ndim) and receivers (nrec, ndim), physical cells."""
    for root in (Path(base), HERE):
        path = root / kind / f"{name}.py"
        if path.is_file():
            return load_module(f"fwibench_{kind}_{name}", path)
    raise FileNotFoundError(f"no {kind} {name!r}: neither {Path(base) / kind} nor "
                            f"{HERE / kind} holds {name}.py")


# ------------------------------------------------------------------ survey


def geometry(cell: Cell):
    """(sources (nshot, 1, ndim), receivers (nrec, ndim)), physical cells:
    ``geometry(shape, survey)`` of the configuration's survey layout."""
    return cell.layout.geometry(cell.shape, cell.config["survey"])
