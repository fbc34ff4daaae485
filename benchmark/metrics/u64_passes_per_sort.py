"""u64_passes_per_sort: radix passes per sort, as the program's
LaunchTimer records them: its `block_sort` (K7) launches, one a pass, so
ceil(end_bit / 8) on the radix path (a count: it repeats exactly)."""

import statistics


def read(run: dict):
    sorts = [s for s in run.get("sorts", ()) if s["launches"]]
    if not sorts:
        return None
    return statistics.fmean(
        sum(x["name"] == "block_sort" for x in s["launches"]) for s in sorts)
