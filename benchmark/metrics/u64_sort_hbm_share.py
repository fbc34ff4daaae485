"""u64_sort_hbm_share: per sort, the least bytes any 8-bit LSD sort of its
items must move (`roofline_u64.sort_bytes`: every key and value read once
and written once a pass, ceil(end_bit / 8) passes, whatever the sort's
kernels) at the HBM peak, over the sort's device span, from its first
launch's start to its last launch's end; mean over sorts, in %. end_bit
is the configuration's call's (every key bit without one)."""

import statistics

from benchmark import roofline, roofline_u64


def read(run: dict):
    config = run["config"]
    end_bit = config["call_kwargs"].get(
        "end_bit", 8 * roofline_u64.key_bytes(config))
    shares = [roofline.hbm_share(
        roofline_u64.sort_bytes(s["n"], run["item_bytes"], end_bit),
        max(x["end_s"] for x in s["launches"])
        - min(x["start_s"] for x in s["launches"]))
        for s in run.get("sorts", ()) if s["launches"]]
    return statistics.fmean(shares) if shares else None
