"""The controls of ``correct``: each cell's judge applied to the outputs
of its control (the configuration module's ``control``: the job computed
one precision below the one the configuration states), on several seeds
at the cell's own size.  Every control has to come out not correct; the
smallest reading of each number is that number's upper reading.

    python3 fembench/control.py --workload <name> --seeds 11 12 13 \
        [--jobs 2]

prints one JSON line a seed: the compared numbers with their limits and
whether the control passed (it must not).  Needs a CUDA device; the
benchmark's own runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--jobs", type=int, default=2)
    args = p.parse_args(argv)

    import torch

    from fembench import harness, spec
    from fembench import traffic as traffic_mod

    harness.environment()
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("fembench control: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    traffic = cell.traffic()
    config_mod = cell.module()
    problem = config_mod.Problem(cell.config, traffic, dev)
    problem.setup({})
    problem.job(traffic_mod.JobStream(traffic["jobs"], 0, stream=1).next())
    runs = []
    for seed in args.seeds:
        stream = traffic_mod.JobStream(traffic["jobs"], seed)
        kept, nodes = [], None
        for k in range(args.jobs):
            params = stream.next()
            t0 = time.perf_counter()
            outputs, nodes = config_mod.control(problem, params)
            torch.cuda.synchronize()
            host = {key: v.cpu() for key, v in outputs.items()}
            kept.append((dict(index=k + 1, params=params,
                              seconds=time.perf_counter() - t0), host))
        runs.append((seed, kept, nodes))
    inputs = problem.release()
    del problem
    torch.cuda.empty_cache()
    for seed, kept, nodes in runs:
        judged = dict(inputs) if nodes is None else dict(inputs, nodes=nodes)
        checks = config_mod.judge(cell.config, traffic, judged, kept, dev)
        passed = all(isinstance(c["value"], float)
                     and c["value"] <= c["limit"] for c in checks.values())
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control_passed": passed,
                          "seconds": [m["seconds"] for m, _ in kept],
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
