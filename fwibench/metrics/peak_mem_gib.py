"""torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats() at its start, in GiB."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 2**30
