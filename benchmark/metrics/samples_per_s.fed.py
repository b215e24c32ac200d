"""samples_per_s.fed: samples_per_s of a cell fed by the host's input path,
a metric of its own because that path repeats less closely than a resident
replay that the card paces."""

DECLARES = {"unit": "samples/s", "source": "host_clock"}


def read(ctx):
    return ctx.counts["samples"] / ctx.counts["window_s"]
