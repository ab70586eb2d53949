"""The device's idle share: 1 - (device-busy seconds an operation) /
(seconds an operation). The busy time is the union of the intervals in
which a kernel, a copy or a fill ran over the profiled operations (the
profiler's trace, CUPTI), per operation; the seconds an operation are
the measured window's, which ran without the profiler, whose own host
cost (a few microseconds a launch) would otherwise count as idle."""

SPANS = []


def read(data):
    t = data.traced
    if not t.busy_s or not t.ops:
        return None
    return 100.0 * (1.0 - (t.busy_s / t.ops) / (data.window_s / data.ops))
