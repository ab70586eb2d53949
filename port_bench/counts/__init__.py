"""The work of one operation of each operation kind, frozen as the
yardstick of the roofline metrics (one module per kind, ``work(config,
traffic)``)."""
