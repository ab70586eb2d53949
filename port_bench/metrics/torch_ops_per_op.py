"""Torch ops one operation dispatches outside the hand-written kernels
(a dispatch counter over one operation after the window): on the card each
is one launch of a PyTorch kernel, paced by the host."""

SPANS = []


def read(data):
    return float(data.torch_ops)
