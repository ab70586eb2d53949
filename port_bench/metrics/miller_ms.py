"""Milliseconds of device time an operation spends in the Miller loops of
its pairing checks (the program's span ``pairing.miller``: B4, B5 and the
packing around them), from the traced pass of ``stages.py``."""

SPANS = []


def read(data):
    return data.stages.get("pairing.miller")
