"""k7_roofline: the radix block sort's (K7, `block_sort`) share of its
roofline, in %: its bytes (`roofline.block_sort_bytes`) at the HBM peak
over its launch's device time, mean over launches. The byte bound is
the larger one: K7's integer work is not bounded by a published peak."""

import statistics

from benchmark import roofline


def read(run: dict):
    shares = [roofline.hbm_share(
        roofline.block_sort_bytes(x["numel"], x["nblocks"], x["radix"],
                                  run["item_bytes"]),
        x["end_s"] - x["start_s"])
        for s in run.get("sorts", ()) for x in s["launches"]
        if x["name"] == "block_sort"]
    return statistics.fmean(shares) if shares else None
