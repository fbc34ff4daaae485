"""pass_hbm_share: per radix pass, the bytes the pass has to move (the
sort's keys, and values, each read once and written once) at the HBM peak,
over the pass's device span, from its first launch's start to its last
launch's end; mean over passes, in %. A pass is the launches that carry
one digit `shift`, with the launches between them that carry none (the
spine), so the reading holds whatever kernels a pass runs."""

import statistics

from benchmark import roofline


def passes(launches: list) -> list[list]:
    out, shift = [], None
    for x in launches:
        if x["shift"] is not None and (not out or x["shift"] != shift):
            shift = x["shift"]
            out.append([])
        if out:
            out[-1].append(x)
    return out


def read(run: dict):
    shares = []
    for s in run.get("sorts", ()):
        for p in passes(s["launches"]):
            span = max(x["end_s"] for x in p) - min(x["start_s"] for x in p)
            shares.append(roofline.hbm_share(
                roofline.pass_bytes(s["n"], run["item_bytes"]), span))
    return statistics.fmean(shares) if shares else None
