"""Milliseconds an operation's device waits on the host inside the pairing
checks (the program's span ``pairing.check``): the untraced idle ms an
operation times the share of the profiled operation's idle gaps that fall
inside a check (``stages.stage_wait``)."""

from port_bench.stages import stage_wait

SPANS = []


def read(data):
    return stage_wait(data, "pairing.check")
