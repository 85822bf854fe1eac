"""Card tests of the benchmark (marked ``gpu``; each skips without a
card): every cell at its own size with a short window comes out correct,
the control (the reference in TF32 in the program's place) does not, and
a checkout of the benchmark alone prints no result.

    python -m pytest --noconftest -m gpu bench_port/tests -q
"""
from __future__ import annotations

import functools
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from bench_port import harness
from bench_port.backends import Reference

ROOT = Path(__file__).resolve().parents[2]
CELLS = [c["name"] for c in harness.benchmark()["workloads"]]

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(cwd, workload, seed, trace=0):
    return subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", "3", "--trace", str(trace)],
        cwd=cwd, capture_output=True, text=True, timeout=1200)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_on_the_card(card, workload):
    res = _run(ROOT, workload, 2 ** 31 + 17)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct_on_the_card(card, workload):
    r = harness.run_cell(harness.benchmark(), workload, 2 ** 31 + 19, 1.0,
                         False, "cuda:0", time.perf_counter(),
                         backend=functools.partial(Reference, prec="tf32"))
    assert not r["correct"], r["checks"]


def test_a_checkout_of_the_benchmark_alone_fails(card, tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path, CELLS[0], 1)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
