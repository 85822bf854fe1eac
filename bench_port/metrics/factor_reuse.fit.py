"""Fits whose factor came from their own NLL evaluation at theta*: the
program's counter ``fit.factor_reuse`` (``GP.fit``: the ``Posterior``
built from the factor and weights L-BFGS-B's last evaluation kept, in
place of ``_factorize``) summed over each fit of the window, mean.
Nothing where the program never counted one since the recorder went on
(a program that always refactorises)."""
from bench_port import program_spans as ps

up = ps.recorder()


def read(run):
    w = ps.window(run, "fit")
    if w is None or "fit.factor_reuse" not in up.counters:
        return None
    return sum(r.n for r in w.spans("fit.factor_reuse")) / len(w.roots)
