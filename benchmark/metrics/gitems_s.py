"""gitems_s: items sorted in the window over the window's wall-clock
seconds, in billions (the reference's own unit, GItems/s)."""


def read(run: dict):
    if not run.get("items"):
        return None
    return sum(run["items"]) / run["window_s"] / 1e9
