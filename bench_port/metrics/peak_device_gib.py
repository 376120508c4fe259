"""peak_device_gib: torch.cuda.max_memory_allocated() over the window,
after a reset at its start, in GiB (the caching allocator's peak)."""


def read(run):
    return run.peak_window_bytes / 2 ** 30 if run.peak_window_bytes else None
