"""setup_s: seconds from the process's start to the window's first call:
imports, the kernels' build or load, the weights, the warm-up."""


def read(rec, mode):
    return rec["setup_s"]
