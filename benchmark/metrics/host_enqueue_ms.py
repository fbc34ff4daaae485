"""host_enqueue_ms: mean host ms of a call into the entry point, up to its
return and before the synchronize (the benchmark's own span, over the
traced window's first phase)."""

import statistics


def read(run: dict):
    spans = run.get("enqueue_s")
    return 1e3 * statistics.fmean(spans) if spans else None
