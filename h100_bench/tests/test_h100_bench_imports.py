"""No module under ``h100_bench/`` imports JAX or the JAX package, and the
reference, the traffic, the counts and the language models' kinds
(``lm/``) import nothing of the program; top-level names compared whole
(``psalm_tpu_torch`` begins with ``psalm_tpu`` and is not it)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "psalm_tpu"}
SOURCES = sorted(BENCH.rglob("*.py"))


def imported_tops(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _id(path):
    return str(path.relative_to(BENCH))


@pytest.mark.parametrize("path", SOURCES, ids=_id)
def test_no_jax(path):
    assert not set(imported_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("path", [p for d in ("reference", "gen", "counts",
                                            "lm")
                                  for p in sorted((BENCH / d).rglob("*.py"))],
                         ids=_id)
def test_yardstick_takes_nothing_of_the_program(path):
    assert "psalm_tpu_torch" not in set(imported_tops(path))


def test_whole_names():
    assert "psalm_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "psalm_tpu.x".split(".")[0] in FORBIDDEN
