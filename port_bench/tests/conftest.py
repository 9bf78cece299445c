"""The benchmark's own tests (``python -m pytest port_bench/tests``): CPU
tests at tiny sizes, and tests marked ``cuda`` that run on the card and skip
without one. They import no JAX."""

import json
import pathlib
import shutil

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips where there is none")


def tiny_configs() -> dict:
    """Tiny copies of the benchmark's configurations, their widths cut so a
    CPU run takes seconds (the port's plain versions run on the CPU)."""
    den = json.loads((ROOT / "port_bench/configs/audiodec_denoise_48k.json").read_text())
    den["name"] = "tiny_denoise"
    den["generator_params"].update(encode_channels=8, decode_channels=8)
    dp = den["course"]["discriminator_params"]
    dp["scale_discriminator_params"].update(channels=16, max_downsample_channels=64,
                                            max_groups=4)
    dp["period_discriminator_params"].update(channels=4, max_downsample_channels=16)
    v1 = json.loads((ROOT / "port_bench/configs/audiodec_v1_48k.json").read_text())
    v1["name"] = "tiny_v1"
    v1["generator_params"].update(encode_channels=8, decode_channels=8, codebook_size=64)
    v1["vocoder_params"].update(channels=64)
    v1["codebook_warmup_frames"] = 200
    return {"tiny_denoise": den, "tiny_v1": v1}


TINY_TRAFFIC = {
    "tiny_fleet": {"driver": "fleet", "streams": 4, "frame_samples": 1200,
                   "signal_seconds": 0.2, "snr_db": 15, "warmup_dispatches": 2,
                   "checked_streams": 3, "trace_seconds": 0.3},
    "tiny_train": {"driver": "train", "batch": 2, "samples": 4800, "batches": 4, "snr_db": 15,
                   "checked_steps": 3, "trace_seconds": 0.5, "dp": 1},
}
# (tiny cell, configuration, traffic, the benchmark's cell whose metrics it reports)
TINY_CELLS = [("tiny_denoise.fleet", "tiny_denoise", "tiny_fleet", "denoise.fleet256.n1"),
              ("tiny_v1.fleet", "tiny_v1", "tiny_fleet", "v1.fleet64.n1"),
              ("tiny_denoise.train", "tiny_denoise", "tiny_train", "denoise.train_adv16")]


def add_tiny_cells(root: pathlib.Path) -> None:
    """Add the tiny cells to the benchmark tree at ``root`` as new files and
    new entries of its BENCHMARK.json, editing no file of port_bench/."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, config in tiny_configs().items():
        path = root / "port_bench" / "configs" / f"{name}.json"
        path.write_text(json.dumps(config))
        bench["configs"].append({"name": name, "source": config["source"],
                                 "file": f"port_bench/configs/{name}.json", "reduced": [],
                                 "why": "a CPU test's tiny copy"})
    for name, traffic in TINY_TRAFFIC.items():
        (root / "port_bench" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    for name, config, traffic, twin in TINY_CELLS:
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "a CPU test's tiny cell"})
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if twin in metric.get("workloads", ()):
                metric["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


@pytest.fixture
def bench_tree(tmp_path, monkeypatch):
    """A copy of the benchmark (BENCHMARK.json and port_bench/'s data and
    readers) with the tiny cells added, which ``port_bench.run`` reads in
    place of the checkout's."""
    root = tmp_path / "tree"
    shutil.copytree(ROOT / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    add_tiny_cells(root)
    import port_bench.run as run

    monkeypatch.setattr(run, "ROOT", root)
    monkeypatch.setattr(run, "HERE", root / "port_bench")
    torch.set_num_threads(4)
    return root


def run_cell(capsys, cell: str, trace: int = 0, seconds: float = 1.0, seed: int = 2**31 + 3):
    """One CPU run of ``cell`` through ``port_bench.run.main``: its exit
    code and its result line."""
    import port_bench.run as run

    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], device=torch.device("cpu"))
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1]) if out else None
