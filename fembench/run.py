"""Run one cell of the benchmark once and print its result line.

    python3 fembench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository's root, on a machine with the CUDA cards the cell
asks for.  The last line of standard output is one JSON object (keys
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``; the compared numbers with their limits
last, under ``checks``); the compared numbers are also the last lines of
standard error.  Without CUDA, without enough cards, without the port
beside it, or with JAX or the JAX package loaded once the window has
closed, it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402

# one process, few host threads: steadier host-paced loops
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "4")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the repository's root, not this folder, heads the import path
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from fembench import harness, spec

    harness.environment()
    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"fembench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import meshfem_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"fembench: the port is not beside the benchmark: {exc}",
              file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"fembench: modules of JAX or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
