"""The device's peak of allocated memory over the run
(`torch.cuda.max_memory_allocated()`), in GB (10^9 bytes)."""


def read(run):
    b = run["memory_peak_bytes"]
    return b / 1e9 if b else None
