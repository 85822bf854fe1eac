"""The share of the profiled requests served by replaying the served
chain's CUDA graphs: the program's counter ``predict.graph_replay``
(``models.gp._predict_packed``) over ``serve.requests``, both summed over
the traced window's requests, %.  Nothing where the program never
captured a graph (no ``predict.graph_*`` counter since the recorder went
on): the CPU, or a program without the graphs."""
from bench_port import program_spans as ps

up = ps.recorder()


def read(run):
    w = ps.window(run, "serve", traced=True)
    if w is None or not any(k.startswith("predict.graph_")
                            for k in up.counters):
        return None
    n = sum(r.n for r in w.spans("serve.requests"))
    if not n:
        return None
    return 100.0 * sum(r.n for r in w.spans("predict.graph_replay")) / n
