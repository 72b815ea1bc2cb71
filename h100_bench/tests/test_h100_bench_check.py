"""The check that decides ``correct``, at the port's tiny config on the CPU
(f32, the kernels' plain versions): a sound run of each cell agrees with
the reference (eval outputs and heads; the training loss, first gradient
and update) within the cell's limits, and a run with a fault planted
underneath the timed path, or the control in the program's place, comes
out not correct. The card's own readings of the same are
``calibrate.py``'s (``test_control_on_the_card``)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from h100_bench.tests import faults, tiny

ROOT = Path(__file__).resolve().parents[2]


def correct(checks):
    return all(v <= limit for _, v, limit in checks)


def run_cell(workload, fault=None, seed=7, trace=False):
    from h100_bench.drivers import eval as ev, train as tr
    torch.set_num_threads(2)
    ctx = tiny.context(workload, seed=seed, seconds=0.3, trace=trace)
    driver = ev if ctx.mix["kind"] == "eval" else tr
    with faults.plant(fault, ctx.mix["kind"]):
        return driver.run(ctx)


@pytest.mark.parametrize("workload", ["eval_panoptic_b8", "eval_referring_b8",
                                      "train_panoptic_b4"])
def test_sound_run_agrees_with_the_reference(workload):
    out = run_cell(workload)
    assert correct(out["checks"]), out["checks"]
    for name, value, limit in out["checks"]:
        assert value <= 1e-4, (name, value)  # f32 against f32


@pytest.mark.parametrize("workload", ["eval_panoptic_b8", "eval_referring_b8",
                                      "train_panoptic_b4"])
def test_traced_run_checks_the_same(workload):
    """A traced run checks the calls of its short window as a timed run
    does, and its readers find their numbers or leave them out."""
    out = run_cell(workload, trace=True)
    assert correct(out["checks"]), out["checks"]
    assert out["per_layer"] and out["busy_s"] >= 0


@pytest.mark.parametrize("workload,fault", [
    *[("eval_panoptic_b8", f) for f in faults.EVAL_FAULTS],
    *[("eval_referring_b8", f) for f in faults.EVAL_FAULTS],
    *[("train_panoptic_b4", f) for f in faults.TRAIN_FAULTS]])
def test_a_fault_comes_out_not_correct(workload, fault):
    out = run_cell(workload, fault)
    assert not correct(out["checks"]), out["checks"]


@pytest.mark.parametrize("fault", [None, "no_exchange", "state_unchanged"])
def test_data_parallel_cell(tmp_path, fault):
    """Two gloo ranks of the data-parallel cell: sound, the gradients not
    summed over the ranks, and the state left unchanged."""
    from h100_bench.drivers.train import free_port
    port, out = free_port(), tmp_path / "checks.json"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "h100_bench.tests.faults",
         "train_panoptic_dp4", str(r), str(port), "2",
         fault or "none", str(out)], cwd=str(ROOT), env=env)
        for r in range(2)]
    assert [p.wait(timeout=300) for p in procs] == [0, 0]
    checks = json.loads(out.read_text())
    assert correct(checks) == (fault is None), checks


def test_control_comes_out_not_correct():
    """The reference in float8 in the program's place, checked as a run
    checks the program."""
    from h100_bench import calibrate
    ctx = tiny.context("eval_panoptic_b8")
    readings = calibrate.eval_readings(ctx, 7)["control"]
    limits = ctx.limits
    assert any(v > limits.get(k, 0.0) for k, v in readings.items()), readings


@pytest.mark.gpu
def test_control_on_the_card():
    """The control at each one-card cell's own size, three seeds: on the
    card only (``python3 -m pytest -m gpu h100_bench/tests``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with open(ROOT / "BENCHMARK.json") as f:
        cells = [w["name"] for w in json.load(f)["workloads"]
                 if w["chips"] == 1]
    for workload in cells:
        got = subprocess.run(
            [sys.executable, str(ROOT / "h100_bench" / "calibrate.py"),
             "--workload", workload, "--seeds", "101,102,103"],
            capture_output=True, text=True, cwd=str(ROOT), timeout=1200)
        assert got.returncode == 0, got.stderr[-4000:]
        with open(ROOT / "h100_bench" / "limits" / f"{workload}.json") as f:
            limits = json.load(f)
        for line in got.stdout.splitlines():
            readings = json.loads(line)["control"]
            assert any(v > limits[k] for k, v in readings.items()
                       if k in limits), readings


def test_change_counts_only_the_elements_the_reference_moves():
    """An element whose reference gradient is nought to rounding (a key
    bias's dimensions that no rotary embedding turns) is left out of the
    change: the program may move it by round-off under Adam."""
    from h100_bench.drivers import train as tr
    grad = torch.tensor([1.0, -2.0, 1e-9, 0.5])
    norm, keep = tr._first(grad)
    assert norm == pytest.approx(float(grad.norm()))
    assert keep.tolist() == [True, True, False, True]


@pytest.mark.parametrize("how,want", [("worst", 9.0), ("median", 3.0)])
def test_eval_numbers_are_taken_at_the_worst_or_median_image(how, want):
    from h100_bench.drivers import eval as ev
    assert ev.at([1.0, 9.0, 2.0, 3.0, 4.0], how) == want
