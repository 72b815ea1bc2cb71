"""``BENCHMARK.json`` against the benchmark's contract: names and units in
the allowed characters, each metric's ``moves`` and cells consistent, the
files each name leads to present, at most a quarter of the cells on four
cards, and the length of a full check within its limit."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "h100_bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_keys_and_sizes(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= len(manifest["command"]) <= 32
    for word in manifest["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_names_units_and_entries(manifest):
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for entry in manifest[group]:
            assert set(entry) == keys, entry
            assert NAME.match(entry["name"]) and _line(entry["why"])
            assert (group, entry["name"]) not in seen
            seen.add((group, entry["name"]))
    for c in manifest["configs"]:
        assert _line(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(manifest["paths"][0] + "/")
        assert (ROOT / c["file"]).exists()
    metric_names = set()
    for group in ("end_to_end", "per_layer"):
        for m in manifest[group]:
            allowed = {"name", "unit", "better", "source", "workloads"}
            allowed |= {"bound"} if group == "end_to_end" else {"layer",
                                                                "moves"}
            assert set(m) <= allowed and set(m) >= allowed - {"workloads"}
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["name"] not in metric_names
            metric_names.add(m["name"])
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_cells_and_metrics_agree(manifest):
    cells = {w["name"]: w for w in manifest["workloads"]}
    configs = {c["name"] for c in manifest["configs"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    pairs = set()
    for w in cells.values():
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
        assert (BENCH / "counts" / f"{w['name']}.json").exists()
        ends = [m for m in manifest["end_to_end"] if _reports(m, w["name"])]
        assert {"setup_s"} < {m["name"] for m in ends}
        assert any(_reports(m, w["name"]) for m in manifest["per_layer"])
    for c in configs:
        assert any(w["config"] == c for w in cells.values())
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_four_card_cells_and_check_length(manifest):
    cells = manifest["workloads"]
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    # a full check of 24 cells: 2 + 14 runs a cell, each run_seconds + 60 s,
    # 2 x 90 s a cell to compile, 1200 s spare, within 43200 s
    n = 24
    total = (2 + 14 * n) * (manifest["run_seconds"] + 60) + n * 180 + 1200
    assert total <= 43200


def test_no_result_without_the_program_or_a_card(tmp_path):
    """A directory that holds only the manifest and the benchmark's files
    gives no result, and neither does a machine without a card."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "eval_panoptic_b8", "--seed", "2147483999", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert got.returncode != 0 and not got.stdout.strip()
