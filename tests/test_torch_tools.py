"""The port's host tools on the CPU: ``analysis`` (the dispatch-log
parser and figures) on a captured port NEB log and on the cases of
tests/test_analysis.py, ``utils_profiling`` (the span recorder's
summary, ``device_trace`` over ``torch.profiler``), ``neb.plot_path`` /
``plot_progress`` from that NEB's trajectory, and ``utils``' metrics and
point-list converters against the JAX package's."""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

import gpr_calculator_tpu.utils as JU
import gpr_calculator_tpu_torch as T
import gpr_calculator_tpu_torch.utils as TU
from gpr_calculator_tpu_torch.analysis import (parse_log, plot_convergence,
                                               plot_energy_scatter)
from gpr_calculator_tpu_torch.dispatch import DispatchPolicy
from gpr_calculator_tpu_torch.neb import plot_path, plot_progress
from gpr_calculator_tpu_torch import utils_profiling
from gpr_calculator_tpu_torch.utils_profiling import device_trace

from test_torch_kff import _on_cpu  # noqa: F401 (fixture)

SAMPLE = """\
Update GP model => 11/10
Loss:      120.301  2.014  1.233
Loss:      118.009  2.110  1.200
From Base model E: 0.020/3.470/3.499, F: 0.159/0.460/0.417
From Surrogate  E: 0.018/100.000/3.489, F: 0.043/0.060/0.380
From Surrogate  E: 0.015/100.000/3.474, F: 0.041/0.060/0.355
From Base model E: 0.031/3.471/3.502, F: 0.201/0.455/0.430
Update GP model => 12/10
Loss:      101.870  2.300  1.150
From Surrogate  E: 0.011/100.000/3.470, F: 0.030/0.060/0.340
"""


@pytest.fixture(scope="module")
def neb_run(tmp_path_factory):
    """A short on-the-fly NEB of the port (set_GPR, then 4 optimiser
    steps) with its printed dispatch log captured and its band written
    to a trajectory."""
    tmp = tmp_path_factory.mktemp("neb")
    images = T.au_on_al100_images()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        gp = T.GP.set_GPR(images, T.EMT(), noise_e=0.05 / 13, noise_f=0.05,
                          log_file=None)
        calc = T.GPR(base=T.EMT(), ff=gp, save=False)
        T.neb_calc(images, calc, fmax=0.05, steps=4,
                   traj=str(tmp / "band.traj"))
    return dict(gp=gp, calc=calc, images=images, log=out.getvalue(),
                traj=str(tmp / "band.traj"), tmp=tmp)


def test_parse_log_of_a_port_neb(neb_run):
    """The port's dispatch lines parse back: one record per base call
    and per surrogate answer the GP counted, one refit per hyperparameter
    optimisation, finite NLLs."""
    gp, s = neb_run["gp"], parse_log(neb_run["log"].splitlines())
    assert s.n_base == gp.use_base > 0
    assert s.n_surrogate == gp.use_surrogate > 0
    assert s.refits == gp.fits >= 1
    assert s.losses and np.all(np.isfinite(s.losses))
    assert np.all(np.isfinite([[r.energy, r.e_std, r.f_std, r.f_max]
                               for r in s.records]))


@pytest.mark.parametrize("prefix", ["", "2026-08-16 10:00:01 INFO "])
def test_parse_log_counts_and_fields(prefix):
    """tests/test_analysis.py's sample log, bare and behind logging
    prefixes."""
    s = parse_log([prefix + ln for ln in SAMPLE.splitlines()])
    assert s.n_base == 2 and s.n_surrogate == 3 and s.refits == 2
    assert s.losses == [120.301, 118.009, 101.870]
    assert abs(s.base_fraction - 2 / 5) < 1e-12
    first, sur = s.records[0], s.records[1]
    assert first.kind == "base" and sur.kind == "surrogate"
    assert (first.energy, first.e_std, first.f_std, first.f_max) == \
        pytest.approx((3.499, 0.020, 0.159, 0.417), abs=1e-12)
    assert abs(sur.energy - 3.489) < 1e-12


def test_base_fraction_series_decays():
    lines = (["From Base model E: 0.1/1.0/1.0, F: 0.2/0.3/0.3"] * 10
             + ["From Surrogate  E: 0.1/1.0/1.0, F: 0.02/0.06/0.3"] * 30)
    frac = parse_log(lines).base_fraction_series(window=10)
    assert abs(frac[0] - 1.0) < 1e-12 and abs(frac[-1]) < 1e-12
    assert np.all(np.diff(frac) <= 1e-12)


def test_parse_real_dispatch_output():
    """The port's DispatchPolicy log lines round-trip."""
    class FakeGP:
        noise_e, noise_f = 0.01, 0.1
        use_base = use_surrogate = 0

    pol = DispatchPolicy(FakeGP(), None, verbose=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        pol.log_base(0.02, 3.47, 3.499, 0.159, 0.46, 0.417)
        pol.log_surrogate(0.018, 100.0, 3.489, 0.043, 0.06, 0.38)
    s = parse_log(buf.getvalue().splitlines())
    assert s.n_base == 1 and s.n_surrogate == 1
    assert abs(s.records[0].energy - 3.499) < 1e-9
    assert abs(s.records[1].energy - 3.489) < 1e-9


def test_analysis_plots_write_files(neb_run):
    s = parse_log(neb_run["log"].splitlines())
    tmp = neb_run["tmp"]
    f1 = plot_energy_scatter(s, n_images=5, output_file=str(tmp / "e.png"))
    f2 = plot_convergence(s, window=2, output_file=str(tmp / "c.png"))
    assert os.path.getsize(f1) > 0 and os.path.getsize(f2) > 0


def test_plot_path_and_plot_progress(neb_run):
    """plot_path from the final band, plot_progress from the trajectory
    of every step (reading it through io.read); rendering freezes the
    calculator and leaves the GP as it was."""
    tmp, gp, calc = neb_run["tmp"], neb_run["gp"], neb_run["calc"]
    images = neb_run["images"]
    energies = [float(im.get_potential_energy()) for im in images]
    plot_path([(images, energies, "final")], figname=str(tmp / "p.png"))
    assert os.path.getsize(tmp / "p.png") > 0
    frames = T.io.read(neb_run["traj"], index=":")
    assert len(frames) % 5 == 0 and len(frames) >= 10
    counts = (gp.use_base, gp.fits, gp.N_energy, gp.N_forces)
    plot_progress(neb_run["traj"], calc, 5, interval=1,
                  figname=str(tmp / "progress.png"))
    assert os.path.getsize(tmp / "progress.png") > 0
    assert (gp.use_base, gp.fits, gp.N_energy, gp.N_forces) == counts
    assert calc.allow_base and calc.update_gpr


def test_phase_timer():
    """The span recorder's summary: calls, total and ms a call by span
    name, and the counters, as a table and as JSON."""
    utils_profiling.clear()
    utils_profiling.enable()
    try:
        for _ in range(3):
            with utils_profiling.span("a"):
                pass
        with utils_profiling.span("b"):
            sum(range(1000))
        utils_profiling.count("c", 5)
    finally:
        utils_profiling.disable()
    s, text, js = (utils_profiling.summary(), utils_profiling.report(),
                   utils_profiling.json())
    utils_profiling.clear()
    assert {k: v["calls"] for k, v in s["spans"].items()} == {"a": 3, "b": 1}
    assert s["counters"] == {"c": 5}
    a = s["spans"]["a"]
    assert a["ms_per_call"] == pytest.approx(a["total_ms"] / 3)
    assert [line.split()[0] for line in text.splitlines()][-1] == "c"
    assert '"calls": 3' in js and '"c": 5' in js


def test_device_trace(tmp_path):
    """logdir None: a no-op; with a directory: a torch.profiler trace of
    the block's CPU operations, exported as a Chrome trace."""
    with device_trace(None) as prof:
        assert prof is None
    with device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_utils_metrics_and_converters_match_jax():
    rng = np.random.RandomState(0)
    y, p = rng.randn(40), rng.randn(40)
    for name in ("rmse", "mae", "r2"):
        assert getattr(TU, name)(y, p) == getattr(JU, name)(y, p)
    out = [io.StringIO(), io.StringIO()]
    for buf, mod in zip(out, (TU, JU)):
        with contextlib.redirect_stdout(buf):
            mod.metric_single(y, p, "E", show_max=True)
            mod.metrics(y, y[:10], p, p[:10], "F")
    assert out[0].getvalue() == out[1].getvalue()
    force = [(rng.randn(n, 5), rng.randn(n, 5, 3), rng.randn(3),
              rng.randint(1, 80, n)) for n in (2, 4, 3)]
    energy = [(rng.randn(n, 5), float(rng.randn()), rng.randint(1, 80, n))
              for n in (3, 1)]
    for data, mode in ((force, "force"), (energy, "energy")):
        for value in (False, True):
            t = TU.list_to_tuple(data, include_value=value, mode=mode)
            j = JU.list_to_tuple(data, include_value=value, mode=mode)
            for a, b in zip(t, j):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        back = TU.tuple_to_list(TU.list_to_tuple(data, mode=mode), mode)
        jback = JU.tuple_to_list(JU.list_to_tuple(data, mode=mode), mode)
        for pt, jp, orig in zip(back, jback, data):
            for a, b in zip(pt, jp):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(pt[0], orig[0])
