"""gather_roofline: the 64-bit radix path's gathers at the HBM peak over
each launch's device time, mean over launches, in %. A sort's last
`gather` writes its output (`out`: a position, a key and a value in, the
key and the value out, `roofline_u64.gather_out_bytes`); one before it
fetches the high words (`hi`: a position and a high word, 16 bits for an
end bit in (32, 48] and 32 above, in, a word out for each padded slot,
`roofline_u64.gather_hi_bytes`). The launch records
keep no field that tells the two apart, so their order does."""

import statistics

from benchmark import roofline, roofline_u64


def read(run: dict):
    config = run["config"]
    key_bytes = roofline_u64.key_bytes(config)
    high = roofline_u64.hi_bytes(key_bytes, config["call_kwargs"].get(
        "end_bit", 8 * key_bytes))
    shares = []
    for s in run.get("sorts", ()):
        gathers = [x for x in s["launches"] if x["name"] == "gather"]
        for i, x in enumerate(gathers):
            nbytes = (roofline_u64.gather_out_bytes(
                x["numel"], key_bytes, config["values"] is not None)
                if i == len(gathers) - 1
                else roofline_u64.gather_hi_bytes(x["numel"], high))
            shares.append(roofline.hbm_share(nbytes,
                                             x["end_s"] - x["start_s"]))
    return statistics.fmean(shares) if shares else None
