"""setup_s: seconds from the start of the process to the start of the
window: imports, CUDA initialisation, loading (on a first run, building)
the kernels, the inputs and their copy to the card, and the warm-up."""


def read(run: dict):
    return run["setup_s"]
