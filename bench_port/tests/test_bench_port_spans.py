"""The readers of the program's own spans and counters
(``program_spans.py`` and the metrics that use it): on the CPU, a tiny
traced run of each cell gives each of its readers a number, or None where
the reader needs the card's trace (``predict_solve_ms.serve`` reads the
span itself there), and ``lbfgs_nfev.fit`` the harness's
own count of evaluations a fit; a program without the recorder gives
None and raises nothing.  On the card (marked ``gpu``) a 3 s traced run
of each cell reads every per-layer metric the cell lists.

    python -m pytest --noconftest -m gpu bench_port/tests/test_bench_port_spans.py -q
"""
from __future__ import annotations

import statistics
import time
import types

import pytest
import torch

from bench_port import harness, program_spans
from bench_port.tests.helpers import run_tiny

BENCH = harness.benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
# the readers of the program's spans, and those of them that need the
# card's trace as well
READERS = {"descriptor_prep_ms.serve", "descriptor_launches.serve",
           "predict_solve_ms.serve", "lbfgs_nfev.fit", "fit_idle_ms.fit",
           "factorize_ms.fit"}
CARD_ONLY = {"descriptor_launches.serve", "fit_idle_ms.fit",
             "factorize_ms.fit"}


def _readers_of(workload):
    return {m["name"] for m in harness.cell_metrics(BENCH, workload, True)
            } & READERS


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_every_reader_is_in_a_cell():
    assert set().union(*map(_readers_of, CELLS)) == READERS


@pytest.mark.parametrize("workload", CELLS)
def test_tiny_traced_run_reads_the_program_spans(monkeypatch, workload):
    counters = {}
    monkeypatch.setattr(harness, "run_cell", _with_counters(counters))
    r = run_tiny(monkeypatch, workload, trace=True)
    assert r["correct"], r["checks"]
    got = {k: v["value"] for k, v in r["metrics"].items() if k in READERS}
    assert set(got) == _readers_of(workload) - CARD_ONLY
    assert all(v > 0 for v in got.values())
    if "lbfgs_nfev.fit" in got:
        assert got["lbfgs_nfev.fit"] == statistics.fmean(
            counters["evals_per_fit"])


def _with_counters(counters):
    run_cell = harness.run_cell

    def run(*args, **kwargs):
        return run_cell(*args, counters=counters, **kwargs)
    return run


def test_readers_read_nothing_without_the_recorder(monkeypatch):
    """A program without the recorder (the readers found none when they
    were loaded): every reader gives None, on a run that holds all a
    reader could ask for."""
    readers = {name: harness.load_reader(name) for name in READERS}
    monkeypatch.setattr(program_spans, "_up", None)
    trace = harness.Trace([("k", 10, 20)], 1.0, 1)
    run = types.SimpleNamespace(
        counters={"requests": 1, "fits": 1}, trace=trace,
        device=torch.device("cuda"))
    for name, reader in readers.items():
        assert reader.read(run) is None, name


@pytest.mark.gpu
def test_card_traced_runs_read_every_metric():
    """Each cell, 3 s traced on the card in this process: every reader of
    the program's spans that it lists reads a number, and so does every
    other per-layer metric but ``serve_mean_ms.serve``, which reads the
    requests after the profiled ones (none in 3 s); lbfgs_nfev.fit is
    the harness's count of evaluations a fit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for workload in CELLS:
        counters = {}
        r = harness.run_cell(BENCH, workload, 2 ** 31 + 23, 3.0, True,
                             "cuda:0", time.perf_counter(),
                             counters=counters)
        want = {m["name"] for m in harness.cell_metrics(BENCH, workload,
                                                        True)}
        assert r["correct"], (workload, r["checks"])
        assert want - {"serve_mean_ms.serve"} <= set(r["metrics"]), \
            (workload, r["metrics"])
        if workload == "bench10k.fit":
            assert r["metrics"]["lbfgs_nfev.fit"]["value"] == \
                statistics.fmean(counters["evals_per_fit"])
