"""Milliseconds of device time an operation spends in the final
exponentiations of its pairing checks (the program's span
``pairing.final_exp``: the easy part on the tower, the hard part's B6-B9
and their torch glue), from the traced pass of ``stages.py``."""

SPANS = []


def read(data):
    return data.stages.get("pairing.final_exp")
