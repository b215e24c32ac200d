"""samples_per_s: every sample of the window's dispatches over the window's
wall time (from a device sync to the sync after the last dispatch)."""

DECLARES = {"unit": "samples/s", "source": "host_clock"}


def read(ctx):
    return ctx.counts["samples"] / ctx.counts["window_s"]
