"""The benchmark of the PyTorch and CUDA port, one run of one cell:

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``port_bench/``
and the port. Everything a cell needs is found by name: the cell in
``BENCHMARK.json``, its configuration file, its traffic mix in
``port_bench/traffic/<traffic>.json``, whose ``driver`` names a module of
``port_bench/drivers/``, and each per-layer metric's reader,
``port_bench/metrics/<metric>.py``. A new cell, mix, configuration or
metric is new files and entries, with no file edited.

With ``--trace 0`` the result carries the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from the run's record (counters
and spans from an untraced window, then a profiled window). The last line
of standard output is the result; the last lines of standard error are the
numbers compared, each beside its limit. Exit codes: 0 with a result; 2
without the card the cell needs; 3 when a JAX module is loaded.
"""

import time

T_START = time.time()  # set-up runs from here to the first timed dispatch or step

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = ROOT / "port_bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "dl_speech_enhancement_tpu")


def cache_dirs():
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / ".cache" / "port_bench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (the port's name starts with the last)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_cell(name: str):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def metrics_of(bench, cell, key) -> list:
    """The cell's metrics of ``bench[key]``: those that list it, or list no cells."""
    return [m for m in bench[key] if cell["name"] in m.get("workloads", [cell["name"]])]


def read_metric(name: str, record: dict):
    """The value that ``port_bench/metrics/<name>.py``'s ``read`` takes from
    the run's record, or None where it finds nothing to read."""
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(record)


def device_info(device, chips: int, out: dict) -> dict:
    import torch

    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": chips, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    trace = (out.get("record") or {}).get("trace")
    if trace:
        info["busy_s"], info["window_s"] = trace["busy_s"], trace["window_s"]
    return info


def main(argv=None, *, device=None) -> int:
    """One run; ``device`` (the tests') skips the look for a card."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    bench, cell, config, traffic = load_cell(args.workload)
    cache_dirs()
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"{cell['name']} needs {cell['chips']} CUDA card(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                  f"device_count={torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = importlib.import_module(f"port_bench.drivers.{traffic['driver']}")
    out = driver.run(config=config, traffic=traffic, seed=args.seed % 2**62,
                     seconds=args.seconds, trace=bool(args.trace), device=device,
                     t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"JAX modules loaded in the run's process: {found}", file=sys.stderr)
        return 3

    if args.trace:
        metrics = {}
        for m in metrics_of(bench, cell, "per_layer"):
            value = read_metric(m["name"], out["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                   for m in metrics_of(bench, cell, "end_to_end")}
    checks = {name: {"value": value, "limit": limit} for name, value, limit in out["checks"]}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info(device, cell["chips"], out)}
    trace = (out.get("record") or {}).get("trace")
    if trace:
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    result["window"] = out.get("window", {})
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
