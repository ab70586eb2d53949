"""Milliseconds an operation's device waits on the host inside the folds
(the program's span ``curve.fold``): the untraced idle ms an operation
times the share of the profiled operation's idle gaps that fall inside a
fold (``stages.stage_wait``)."""

from port_bench.stages import stage_wait

SPANS = []


def read(data):
    return stage_wait(data, "curve.fold")
