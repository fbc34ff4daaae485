"""glue_ms: mean device ms of a sort outside the program's kernel
launches: a CUDA event pair around the call, less every launch that the
program's LaunchTimer records inside it. What is left is the torch ops of
the entry point (encode, pad, count masks, slice, decode) and the device's
idle time between launches."""

import statistics


def read(run: dict):
    sorts = [s for s in run.get("sorts", ()) if s["launches"]]
    if not sorts:
        return None
    return 1e3 * statistics.fmean(
        s["call_s"] - sum(x["end_s"] - x["start_s"] for x in s["launches"])
        for s in sorts)
