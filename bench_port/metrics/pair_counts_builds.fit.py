"""Builds of the Dot NLL's pair counts a fit: the program's counter
``pair_counts.build`` (``ops.kernels.pair_counts``) summed over each fit
of the window, mean.  Nothing where the program never counted one since
the recorder went on (a program that rebuilds the pair-count matrix in
every evaluation without counting it)."""
from bench_port import program_spans as ps

up = ps.recorder()


def read(run):
    w = ps.window(run, "fit")
    if w is None or "pair_counts.build" not in up.counters:
        return None
    return sum(r.n for r in w.spans("pair_counts.build")) / len(w.roots)
