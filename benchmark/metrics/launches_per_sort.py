"""launches_per_sort: kernel launches of the program per sort, as its
LaunchTimer records them (a count: it repeats exactly)."""

import statistics


def read(run: dict):
    sorts = run.get("sorts")
    if not sorts or not any(s["launches"] for s in sorts):
        return None
    return statistics.fmean(len(s["launches"]) for s in sorts)
