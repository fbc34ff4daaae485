"""split_pad_roofline: the 64-bit radix path's first kernel (`split_pad`:
the keys and values in, a low word and a position out for each padded
slot, a (key, value) record for each item, and for an end bit past 32 a
high word for each padded slot, in 16 bits up to bit 48 and 32 above,
`roofline_u64.split_pad_bytes`) at the
HBM peak over its launch's device time, mean over launches, in %."""

import statistics

from benchmark import roofline, roofline_u64


def read(run: dict):
    config = run["config"]
    key_bytes = roofline_u64.key_bytes(config)
    high = roofline_u64.hi_bytes(key_bytes, config["call_kwargs"].get(
        "end_bit", 8 * key_bytes))
    shares = [roofline.hbm_share(
        roofline_u64.split_pad_bytes(s["n"], x["numel"], key_bytes,
                                     config["values"] is not None, high),
        x["end_s"] - x["start_s"])
        for s in run.get("sorts", ()) for x in s["launches"]
        if x["name"] == "split_pad"]
    return statistics.fmean(shares) if shares else None
