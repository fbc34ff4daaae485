"""sort_ms_p95: the 95th percentile, in ms, of every sort in the window,
each timed on the host clock from its call to the return of its
synchronize."""

import statistics


def read(run: dict):
    times = run.get("sort_s") or []
    if len(times) < 2:
        return None
    return 1e3 * statistics.quantiles(times, n=100)[94]
