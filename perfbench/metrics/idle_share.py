"""idle_share: the share of the profiled slices' wall time in which no
operation ran on the device (the union of the trace's device intervals
is the busy time), in %."""


def read(run):
    red = run.trace
    if red is None or red["window_s"] <= 0 or red["n_dev"] == 0:
        return None
    return 100.0 * (1.0 - red["busy_us"] / 1e6 / red["window_s"])
