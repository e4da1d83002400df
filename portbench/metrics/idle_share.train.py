"""The device's idle share over the traced steps of a training cell:
1 - (union of kernel, copy and set intervals) / (the traced window), %."""


def read(ctx):
    t = ctx.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
