"""Readings that set the limits of a cell's check, many seeds in one process:

    python3 -m port_bench.control --workload <cell> --seconds <s> --seeds 1 2 3 [--control]

Each seed runs the cell's driver as a run of the benchmark does (its own
size, a window of ``--seconds``) and prints the numbers its check compares.
``--control`` puts the lower precision the check has to fail in the
program's place: for a serving cell the port's own bf16-weight route, for a
training cell the same program with TF32 on. The benchmark's own runs never
run it. One JSON line a seed; the last line gathers the largest reading of
each number over the seeds.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from port_bench.run import cache_dirs, forbidden_modules, load_cell


def main(argv=None, *, device=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", action="store_true")
    args = parser.parse_args(argv)
    _, cell, config, traffic = load_cell(args.workload)
    cache_dirs()
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA card", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    driver = importlib.import_module(f"port_bench.drivers.{traffic['driver']}")
    worst: dict = {}
    for seed in args.seeds:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        extra = driver.control_arguments() if args.control else {}
        out = driver.run(config=config, traffic=traffic, seed=seed % 2**62,
                         seconds=args.seconds, trace=False, device=device,
                         t_start=time.time(), **extra)
        readings = {name: value for name, value, _ in out["checks"]}
        for name, value in readings.items():
            worst[name] = max(worst.get(name, value), value)
        print(json.dumps({"workload": cell["name"], "seed": seed, "control": args.control,
                          "readings": readings, "attempted": out["attempted"],
                          "e2e": out["e2e"], "window": out["window"]}), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"workload": cell["name"], "control": args.control, "seeds": args.seeds,
                      "largest": worst, "forbidden": forbidden_modules()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
