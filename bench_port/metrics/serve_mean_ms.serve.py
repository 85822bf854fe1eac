"""Mean request latency of a traced run's requests that the profiler did
not see (those after ``trace_requests``), ms: the mean beside the
window's 95th percentile, which the end-to-end metric holds."""
import statistics


def read(run):
    lat = run.counters.get("untraced_latencies_s")
    return 1e3 * statistics.fmean(lat) if lat else None
