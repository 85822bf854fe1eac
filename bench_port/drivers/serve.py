"""Served structures in a closed loop with one client: each request is
one structure, E, F and their stds on the host before the next is sent
(``GP.predict_structure(atoms, return_std=True)``).  The seed draws each
request's image (uniform over the images of the configuration's served
system) and a Gaussian displacement of its free atoms."""
from __future__ import annotations

import math
import time

import numpy as np

from .. import harness
from ..backends import Port, Reference
from ..systems import rng


class State:
    pass


def _requests(gen, system, n, sd):
    choice = gen.integers(0, len(system.images), n)
    disp = gen.normal(0.0, sd, (n, len(system.geo.free), 3))
    return choice, disp


def _positions(system, choice, disp):
    p = system.images[choice].copy()
    p[system.geo.free] += disp
    return p


def setup(run, system, backend=None):
    tr = run.traffic
    st = State()
    st.system = system
    st.choice, st.disp = _requests(rng(run.seed, 2), system,
                                   tr["max_requests"], tr["displacement"])
    st.backend = (backend or Port)(system)
    st.backend.fit(opt=system.serve_opt)
    st.theta, st.alpha = st.backend.theta(), st.backend.alpha()
    run.inputs = system.work_inputs()
    # every image once, then perturbed ones from a stream of their own
    for p in system.images:
        st.backend.serve(p.copy())
    wc, wd = _requests(rng(run.seed, 3), system, tr["warmup"],
                       tr["displacement"])
    for c, d in zip(wc, wd):
        st.backend.serve(_positions(system, c, d))
    harness.sync(run.device)
    return st


def window(run, st):
    lat, outs = [], []
    n_max = len(st.choice)
    n_trace = run.traffic["trace_requests"] if run.traced else 0
    # the profiler starts before the window's clock: its start-up is no
    # request's time
    prof = harness.Profiler(run.device).__enter__() if n_trace else None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        k = len(outs)
        if k >= n_max:
            raise RuntimeError(f"the stream's {n_max} requests ran out")
        p = _positions(st.system, st.choice[k], st.disp[k])
        a = time.perf_counter()
        out = st.backend.serve(p)
        harness.sync(run.device)
        lat.append(time.perf_counter() - a)
        outs.append(out)
        if prof is not None and k + 1 == n_trace:
            prof.__exit__(None, None, None)
            t_prof = (prof, k + 1)
            prof = None
    if prof is not None:
        prof.__exit__(None, None, None)
        t_prof = (prof, len(outs))
    if n_trace:
        p, items = t_prof
        run.trace = harness.Trace(p.ops(), p.window_s, items,
                                  run.spans.intervals)
    st.outs = outs
    n = len(outs)
    run.counters["requests"] = n
    # the requests the profiler did not see, for a traced run's mean
    run.counters["untraced_latencies_s"] = lat[n_trace:]
    failed = sum(1 for o in outs
                 if not all(np.all(np.isfinite(v)) for v in o))
    return {"serve_p95_ms": 1e3 * np.percentile(lat, 95)}, n, failed


def release(st):
    st.backend.release()


def check(run, st, system):
    """The reference's own fit (its own L-BFGS-B where the set-up
    optimises, else theta0) and factor, then a sample of the window's
    requests drawn from the seed, each served again by the reference:
    the widest gaps of E (eV), F (eV/A) and the variances of E per
    atom (eV^2) and of F ((eV/A)^2).  Besides, the program's weights
    against the reference's (``alpha_rel``), and E and F against the
    reference's blocks times the program's weights (``*_at_alpha``): at
    10 000 rows the float32 weights' own error swamps the served mean's,
    and these part the two.  The limits file names those compared."""
    n = len(st.outs)
    k = min(run.traffic["sample"], n)
    sample = np.sort(rng(run.seed, 4).choice(n, size=k, replace=False))
    ref = Reference(system, prec="f64")
    ref.fit(opt=system.serve_opt)
    values = {}
    if system.serve_opt:
        th = ref.theta()
        values["theta_rel"] = float(np.max(np.abs(st.theta - th)
                                           / np.abs(th)))
    alpha = ref.alpha()
    # weights of another number of rows answer another training set
    values["alpha_rel"] = (
        float(np.max(np.abs(st.alpha - alpha)) / np.max(np.abs(alpha)))
        if st.alpha.shape == alpha.shape else math.inf)
    gaps = np.zeros(6)
    for i in sample:
        got = st.outs[i]
        p = _positions(system, st.choice[i], st.disp[i])
        want = ref.serve(p)
        at_alpha = (ref.serve(p, alpha=st.alpha)
                    if st.alpha.shape == alpha.shape else (math.inf,) * 2)
        # the stds compared as variances: a std near zero is the root of
        # rounding, sqrt(|var|), and says nothing of the model
        got = (got[0], got[1], got[2] ** 2, np.square(got[3]), got[0],
               got[1])
        want = (want[0], want[1], want[2] ** 2, np.square(want[3]),
                at_alpha[0], at_alpha[1])
        gaps = np.maximum(gaps, [float(np.max(np.abs(np.asarray(g) - w)))
                                 for g, w in zip(got, want)])
    values.update(e_err_ev=gaps[0], f_err_ev_a=gaps[1], var_e_err=gaps[2],
                  var_f_err=gaps[3], e_err_at_alpha_ev=gaps[4],
                  f_err_at_alpha_ev_a=gaps[5])
    ref.release()
    return {k: float(v) for k, v in values.items()}
