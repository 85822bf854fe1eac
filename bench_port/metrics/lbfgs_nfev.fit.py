"""L-BFGS-B's evaluations a fit: the program's counter ``lbfgs.nfev``
(scipy's ``nfev`` of each ``GP._minimize``) summed over each fit of the
window, mean."""
from bench_port import program_spans as ps

ps.recorder()


def read(run):
    w = ps.window(run, "fit")
    if w is None:
        return None
    return sum(r.n for r in w.spans("lbfgs.nfev")) / len(w.roots)
