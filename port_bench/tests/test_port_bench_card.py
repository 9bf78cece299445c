"""The benchmark's cells on the card, at their own sizes (``python -m pytest
port_bench/tests -m cuda`` on a machine with an H100): each cell runs
correct, and its lower-precision control fails the check. Skips without a
card."""

import importlib
import json
import time

import pytest
import torch

from port_bench import run
from port_bench.tests.conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, capsys, cell):
    rc = run.main(["--workload", cell, "--seed", str(2**31 + 11), "--seconds", "3",
                   "--trace", "1"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check(card, cell):
    _, _, config, traffic = run.load_cell(cell)
    driver = importlib.import_module(f"port_bench.drivers.{traffic['driver']}")
    out = driver.run(config=config, traffic=traffic, seed=2**31 + 12, seconds=2, trace=False,
                     device=card, t_start=time.time(), **driver.control_arguments())
    assert any(value > limit for _, value, limit in out["checks"]), out["checks"]
