"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 -m fwibench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``;
its configuration, traffic mix, check, physics, survey layout and metrics
are the files of ``fwibench/`` of those names. The last line of standard
output is the result's JSON object (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics, from one profiled evaluation). It
exits 2, and prints no result, without a CUDA card or with fewer cards than
the cell asks for: it never falls back to the CPU; and 3 where the run
loaded JAX or the JAX package, which the benchmark never measures.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels"}
# top-level module names of JAX and of the JAX package beside the port
JAX_MODULES = {"jax", "jaxlib", "flax", "tpufwi"}


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m fwibench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".fwibench_cache" / sub)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card and never runs on the CPU")
        return 2
    from fwibench import harness, spec

    cell = spec.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} cards; {torch.cuda.device_count()} found")
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START, log=log)
    loaded = sorted(JAX_MODULES & {m.partition(".")[0] for m in sys.modules})
    if loaded:
        log(f"the run loaded {', '.join(loaded)}: the benchmark measures the port alone")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
