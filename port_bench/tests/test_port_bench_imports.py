"""What the benchmark may import and read: no JAX, no JAX package, and a
reference that takes nothing from the port."""

import ast
import pathlib
import sys

import pytest

from port_bench import run
from port_bench.tests.conftest import ROOT

BENCH = ROOT / "port_bench"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & set(run.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_from_the_port(path):
    assert "dl_speech_enhancement_tpu_torch" not in top_level_imports(path)
    assert "dl_speech_enhancement_tpu_torch" not in path.read_text()


@pytest.mark.parametrize("path", [p for p in SOURCES if "tests" not in p.parts],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_era_file_is_named(path):
    text = path.read_text()
    for name in ("bench.py", "BASELINE", "BENCH_r", "MULTICHIP_r"):
        assert name not in text


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dl_speech_enhancement_tpu_torch_extra", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dl_speech_enhancement_tpu.models", object())
    assert run.forbidden_modules() == ["dl_speech_enhancement_tpu"]
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run.forbidden_modules() == ["dl_speech_enhancement_tpu", "jaxlib"]
