"""A cell of ``BENCHMARK.json`` and the files it names, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json``, ``checks/<cell>.json``
and ``metrics/<metric>.py``; and the survey geometry a configuration's
layout describes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np

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
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(base / "configs" / f"{w['config']}.json"),
                traffic=load_json(base / "traffic" / f"{w['traffic']}.json"),
                check=load_json(base / "checks" / f"{name}.json"),
                end_to_end=metrics_for(bench["end_to_end"], name),
                per_layer=metrics_for(bench["per_layer"], name))


def reader(metric: str):
    """``read(run)`` of ``metrics/<metric>.py``: the metric's value, or None
    where the run holds nothing to read it from."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"fwibench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------------ survey


def split_spread(shape, s):
    """Shots evenly spread along x (the ends left out), every shot recorded
    by one receiver line (``tpufwi_torch.acquisition.split_spread_survey``)."""
    nx = shape[1]
    sx = np.linspace(0, nx - 1, s["shots"] + 2)[1:-1].round().astype(np.int64)
    src = np.array([[[s["src_depth"], x]] for x in sx])
    rx = np.arange(0, nx, s["rcv_every"])
    rcv = np.stack([np.full_like(rx, s["rcv_depth"]), rx], 1)
    return src, rcv


def carpet(shape, s):
    """Surface shots on a (y, x) grid and a receiver carpet every
    ``rcv_every`` cells, 10 cells in from the sides
    (``scripts/overthrust_ms.py:97-140``)."""
    ny, _, nx = shape
    ey, ex = s["rcv_every"]
    rcv = np.array([[y, s["rcv_depth"], x] for y in range(10, ny - 10, ey)
                    for x in range(10, nx - 10, ex)])
    sy, sx = s["shots"]
    src = np.array([[[int(y), s["src_depth"], int(x)]] for y in np.linspace(0.2 * ny, 0.8 * ny, sy)
                    for x in np.linspace(0.15 * nx, 0.75 * nx, sx)])
    return src, rcv


LAYOUTS = {"split_spread": split_spread, "carpet": carpet}


def geometry(cell: Cell):
    """(sources (nshot, 1, ndim), receivers (nrec, ndim)), physical cells."""
    s = cell.config["survey"]
    return LAYOUTS[s["layout"]](cell.shape, s)
