"""The device's share of its roofline over the profiled operations: the
least time the card could take for their work (``counts/``: the larger of
32-bit integer results over the issue peak and bytes over the memory
peak) over the time the device was busy."""

SPANS = []


def read(data):
    t = data.traced
    if not t.busy_s or not t.ops:
        return None
    return 100.0 * data.work["least_s"] * t.ops / t.busy_s
