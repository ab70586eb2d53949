"""The operation kinds the traffic mixes run (one module each).

A module exposes ``setup(ctx)`` (inputs from the seed, on the device),
``warm(state)`` (the op indices whose shapes set-up runs once),
``op(state, i)`` (the i-th operation of the window, synchronised; returns
its record), ``units(state)`` (work units of one op) and ``check(state,
records)`` (the reference's comparisons after the window). ``trace_ops``
in the traffic file says how many ops the profiler traces.
"""
