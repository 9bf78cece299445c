"""Whole runs of tiny cells on the CPU, through ``port_bench.run.main`` with
the look for a card skipped: the port's plain route against the reference,
the lower-precision control and planted faults against the check, a stall
against the tail, and a cell added as data files only."""

import hashlib
import time

import pytest
import torch

from port_bench.drivers import fleet, train
from port_bench.run import load_cell
from port_bench.tests.conftest import ROOT, run_cell


@pytest.mark.parametrize("cell", ["tiny_denoise.fleet", "tiny_v1.fleet", "tiny_denoise.train"])
def test_the_plain_route_agrees_with_the_reference(bench_tree, capsys, cell):
    rc, result = run_cell(capsys, cell)
    assert rc == 0 and result["correct"], result
    for name, check in result["checks"].items():
        assert check["value"] < 1e-5, name
    assert result["metrics"]["setup_s"]["value"] > 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", ["tiny_denoise.fleet", "tiny_v1.fleet"])
def test_the_bf16_weight_control_fails_the_check(bench_tree, cell):
    _, _, config, traffic = load_cell(cell)
    out = fleet.run(config=config, traffic=traffic, seed=5, seconds=0.3, trace=False,
                    device=torch.device("cpu"), t_start=time.time(),
                    **fleet.control_arguments())
    assert any(value > limit for _, value, limit in out["checks"]), out["checks"]


def wrap_fleet(monkeypatch, fault):
    build = fleet.build

    def broken(*args, **kwargs):
        built = build(*args, **kwargs)
        return built._replace(run=fault(built.run))

    monkeypatch.setattr(fleet, "build", broken)


def altered_answer(run):
    calls = [0]

    def altered(cache, x):
        audio, cache, codes = run(cache, x)
        calls[0] += 1
        if calls[0] == 4:
            audio = audio.clone()
            audio[0, :, 100] += 0.05
        return audio, cache, codes

    return altered


def unchanged_state(run):
    def stale(cache, x):
        audio, _, codes = run(cache, x)
        return audio, cache, codes

    return stale


def altered_code(run):
    def altered(cache, x):
        audio, cache, codes = run(cache, x)
        return audio, cache, (codes + 1) % 64 + (codes // 64) * 64

    return altered


@pytest.mark.parametrize("cell,fault", [
    ("tiny_denoise.fleet", altered_answer), ("tiny_denoise.fleet", unchanged_state),
    ("tiny_v1.fleet", altered_answer), ("tiny_v1.fleet", unchanged_state),
    ("tiny_v1.fleet", altered_code)], ids=lambda f: getattr(f, "__name__", f))
def test_a_broken_fleet_is_not_correct(bench_tree, capsys, monkeypatch, cell, fault):
    wrap_fleet(monkeypatch, fault)
    rc, result = run_cell(capsys, cell, seconds=0.5)
    assert rc == 0 and not result["correct"], result["checks"]


def wrap_train(monkeypatch, fault):
    build = train.build

    def broken(*args, **kwargs):
        step, models, opts, states = build(*args, **kwargs)
        return fault(step, models), models, opts, states

    monkeypatch.setattr(train, "build", broken)


def state_unchanged(step, models):
    def kept(x, t):
        held = [p.detach().clone() for m in models for p in m.parameters()]
        out = step(x, t)
        with torch.no_grad():
            for p, h in zip((p for m in models for p in m.parameters()), held):
                p.copy_(h)
        return out

    return kept


def half_batch(step, models):
    return lambda x, t: step(x[:x.shape[0] // 2], t[:t.shape[0] // 2])


def altered_loss(step, models):
    def altered(x, t):
        g, d, *rest = step(x, t)
        return (g * 1.001, d, *rest)

    return altered


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, altered_loss],
                         ids=lambda f: f.__name__)
def test_a_broken_training_step_is_not_correct(bench_tree, capsys, monkeypatch, fault):
    wrap_train(monkeypatch, fault)
    rc, result = run_cell(capsys, "tiny_denoise.train", seconds=0.5)
    assert rc == 0 and not result["correct"], result["checks"]


def test_a_stall_in_one_dispatch_moves_the_tail(bench_tree, capsys, monkeypatch):
    rc, steady = run_cell(capsys, "tiny_denoise.fleet", seconds=0.6)
    n = steady["attempted"]

    def stall(run):
        calls = [0]

        def stalled(cache, x):
            calls[0] += 1
            if calls[0] == 5:  # the window's third dispatch, after two warm-up ones
                time.sleep(0.8)
            return run(cache, x)

        return stalled

    wrap_fleet(monkeypatch, stall)
    rc, stalled = run_cell(capsys, "tiny_denoise.fleet", seconds=0.6)
    assert rc == 0 and stalled["correct"]
    # one dispatch of the few the window holds: the 95th percentile of all of them moves
    assert stalled["attempted"] <= n
    assert stalled["metrics"]["dispatch_p95_ms"]["value"] > \
        steady["metrics"]["dispatch_p95_ms"]["value"] + 200


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "port_bench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_and_a_metric_added_as_files_only(bench_tree, capsys):
    import json

    original = digests(ROOT)
    tree = {p: d for p, d in digests(bench_tree).items() if p in original}
    # the fixture added its tiny configurations and mixes as new files alone
    assert tree == {p: d for p, d in original.items() if p in tree}
    (bench_tree / "port_bench" / "metrics" / "dispatch_rate.serve.py").write_text(
        "def read(record):\n"
        "    if record.get('kind') != 'serve':\n"
        "        return None\n"
        "    return record['calls'] / record['window_s']\n")
    bench = json.loads((bench_tree / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "dispatch_rate.serve", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "fleet entry, host",
                               "moves": "rt_streams", "workloads": ["tiny_denoise.fleet"]})
    (bench_tree / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, result = run_cell(capsys, "tiny_denoise.fleet", trace=1, seconds=0.5)
    assert rc == 0 and result["correct"]
    assert result["metrics"]["dispatch_rate.serve"]["value"] > 0
    assert {"host_ms.serve", "mfu.serve", "dispatch_rate.serve"} <= set(result["metrics"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
