"""The limits' two readings for one cell, in one process on the card:
for each seed, a short run of the program (the evaluations up to the
captured one, at the cell's own load and sizes) compared with the
reference, which gives the lower reading; and for the first ``--control``
seeds also the control, the reference computed with bfloat16 fields in the
program's place on the same shots and inputs, which gives the upper one.
One JSON line a seed.

    python3 -m fwibench.control --workload <cell> --seeds <n> [<n> ...] [--control 3]
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m fwibench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3, help="seeds that also run the control")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from fwibench import harness, spec

    cell = spec.load_cell(args.workload)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        out = harness.run_cell(cell, seed, 0.0, False, torch.device("cuda", 0), t0,
                               log=lambda m: print(m, file=sys.stderr, flush=True),
                               control=torch.bfloat16 if i < args.control else None)
        line = {"workload": cell.name, "seed": seed, "seconds": time.perf_counter() - t0,
                "program": {k: v["value"] for k, v in out["check"].items()},
                "control": out.get("control")}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
