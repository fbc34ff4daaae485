"""k8_roofline: the radix placement's (K8, `place`) share of its
roofline, in %: its bytes (`roofline.place_bytes`) at the HBM peak over
its launch's device time, mean over launches."""

import statistics

from benchmark import roofline


def read(run: dict):
    shares = [roofline.hbm_share(
        roofline.place_bytes(x["numel"], x["nblocks"], x["radix"],
                             run["item_bytes"]),
        x["end_s"] - x["start_s"])
        for s in run.get("sorts", ()) for x in s["launches"]
        if x["name"] == "place"]
    return statistics.fmean(shares) if shares else None
