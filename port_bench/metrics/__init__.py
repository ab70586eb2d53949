"""Per-layer metric readers, one module per quantity.

A metric ``<quantity>.<scope>`` of ``BENCHMARK.json`` is read by
``metrics/<quantity>.py``: ``SPANS`` lists the program functions it
brackets in the traced run (``"module:attr"`` or ``"module:obj.attr"``,
with a label), and ``read(data)`` reduces the run's readings to one
number, or returns None where the cell gave it nothing to read. ``data``
has ``spans`` ({label: [ms]}), ``ops`` (operations in the window),
``window_s``, ``traced`` (the profiled operations: ``busy_s``,
``window_s``, ``ops``), ``torch_ops`` (of one operation) and ``work``
(the operation's work from ``counts/``).
"""
