"""Share of the profiled stretch in which no kernel, copy or memset ran
on the device, in %."""


def read(run):
    p = run.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
