"""The share of a window of the card alone (profiled without host
operations, whose recording would slow the host) in which no device
operation ran, in %: from the first launch to the last operation's end."""


def read(r):
    t = r.device_trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None
