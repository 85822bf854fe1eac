"""Hyperparameter refits: ``GP.fit(opt=True, maxiter=...)`` from the
configuration's theta0 (the kernel reset before each), whole fits one
after another until the window's seconds have passed; L-BFGS-B over the
analytic NLL, at most the traffic's ``maxiter`` iterations, then the
factorisation.  The cap gives every seed's draws the same work (3
iterations, 5 evaluations at bench10k; without it 3 or 4 by the draws)."""
from __future__ import annotations

import math
import time

import numpy as np

from .. import harness
from ..backends import Port
from ..reference import gp as rgp


class State:
    pass


def setup(run, system, backend=None):
    st = State()
    st.backend = (backend or Port)(system)
    st.theta0 = np.array(system.theta0, float)
    st.maxiter = run.traffic["maxiter"]
    run.inputs = system.work_inputs()
    for _ in range(run.traffic["warmup"]):
        st.backend.fit(opt=True, theta=st.theta0, maxiter=st.maxiter)
    harness.sync(run.device)
    return st


def window(run, st):
    be = st.backend
    first = len(be.evals)
    n = 0
    prof = harness.Profiler(run.device).__enter__() if run.traced else None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        be.fit(opt=True, theta=st.theta0, maxiter=st.maxiter)
        harness.sync(run.device)
        n += 1
    elapsed = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
        run.trace = harness.Trace(prof.ops(), prof.window_s, n,
                                  run.spans.intervals)
    evals = be.evals[first:]
    st.first_eval = evals[-1][0]
    st.theta, st.alpha = be.theta(), be.alpha()
    run.counters.update(fits=n, nll_evals=sum(len(e) for e in evals),
                        evals_per_fit=[len(e) for e in evals])
    failed = 0 if np.all(np.isfinite(st.theta)) else 1
    return {"fit_s": elapsed / n}, n, failed


def release(st):
    st.backend.release()


def check(run, st, system):
    """The reference's own L-BFGS-B from theta0, with the same cap and the
    configuration's kernel family (float64 blocks and
    linear algebra): the NLL and gradient at theta0 against the window's
    last fit's first evaluation, theta* against the program's, and the
    weights at the program's theta* against the program's."""
    data = system.ref_data("f64")
    theta, evals = rgp.fit(data, st.theta0, system.bounds, system.noise,
                           system.zeta, system.family, maxiter=st.maxiter)
    _, nll0, g0 = evals[0]
    _, nll_p, g_p = st.first_eval
    _, alpha = rgp.factorize(data, st.theta, system.noise, system.zeta,
                             system.family)
    alpha = alpha.cpu().numpy()
    # weights of another number of rows answer another training set
    a_rel = (float(np.max(np.abs(st.alpha - alpha)) / np.max(np.abs(alpha)))
             if st.alpha.shape == alpha.shape else math.inf)
    return {
        "nll0_rel": abs(nll_p - nll0) / abs(nll0),
        "grad0_rel": float(np.linalg.norm(g_p - g0) / np.linalg.norm(g0)),
        "theta_rel": float(np.max(np.abs(st.theta - theta)
                                  / np.abs(theta))),
        "alpha_rel": a_rel,
    }
