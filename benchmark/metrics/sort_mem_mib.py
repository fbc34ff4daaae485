"""sort_mem_mib: the device memory one sort holds at its peak (scratch
and output), in MiB: the allocator's peak over the window less what was
allocated as the window began (the inputs, and the last output of each
input in rotation, which the check keeps)."""


def read(run: dict):
    held = run.get("window_mem_bytes")
    return None if held is None else held / 2**20
