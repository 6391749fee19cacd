"""Peak device memory of the window (``torch.cuda.max_memory_allocated``
after the warm-up study), GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes > 0 else None
