"""device_idle_share: the share, in %, of a slice of the traced window in
which no kernel or copy ran on the device: the complement of the union of
the device's intervals, over the slice's span on the device. The slice is
profiled for device activity only, so that the profiler records nothing
on the host and slows it little."""


def read(run: dict):
    busy = run.get("device_busy")
    if not busy or busy["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - busy["busy_s"] / busy["window_s"])
