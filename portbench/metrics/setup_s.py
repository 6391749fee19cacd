"""Set-up: process start to the first timed study (imports, the CUDA
context, the kernels' build or load, one warm-up study)."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
