"""peak_mem_gib: the device memory the program held at its peak, in GiB:
``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``, less
what the benchmark's own inputs (the resident pool) held at the reset."""

DECLARES = {"unit": "GiB", "source": "device_trace"}


def read(ctx):
    return ctx.counts["peak_bytes"] / 2 ** 30
