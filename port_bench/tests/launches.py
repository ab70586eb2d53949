"""Launch shapes of one operation on the CPU, as the card would launch
them: ``mont.on_card`` answers True (so inversions take the card's one-B2
form), every kernel's wrapper is its plain version, counted in the
program's own ``Kernel.count`` counters (one launch per outermost call; a
plain version that calls another, as a tower kernel's products do, is one
launch), with the lanes of each."""

from __future__ import annotations

import contextlib

from port_bench import trace


def lanes_of(name, args):
    """(key, lanes) of one launch: B1/B2 by field, the rest by kernel."""
    if name in ("mont_mul", "mont_pow"):
        return f"{name}.{args[0].name}", args[1].shape[0]
    if name == "sha3_chunks":
        return name, args[0].shape[0]
    if name.endswith("winacc"):
        return name, args[1].shape[1]
    return name, args[0].shape[-1]


@contextlib.contextmanager
def recorded():
    """Yields {key: [launches, lanes]}, filled while the block runs."""
    seen, active, saved = {}, [False], []

    def counted(k, fn):
        def run(*args):
            if active[0]:
                return fn(*args)
            key, lanes = lanes_of(k.name, args)
            k.count.add(lanes)
            entry = seen.setdefault(key, [0, 0])
            entry[0] += 1
            entry[1] += lanes
            active[0] = True
            try:
                return fn(*args)
            finally:
                active[0] = False
        return run

    from threshold_crypto_tpu_torch.device import mont

    for mod, k in trace.kernels():
        k.count.reset()
        for name in (k.launch.__name__, k.plain.__name__):
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, counted(k, k.plain))
    saved.append((mont, "on_card", mont.on_card))
    mont.on_card = lambda a: True
    try:
        yield seen
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)
