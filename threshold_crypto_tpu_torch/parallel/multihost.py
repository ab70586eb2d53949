"""Multi-process runtime: ``torch.distributed`` bring-up, the global mesh,
the dealer's broadcast of protocol bytes, and a guard on replicated state.

The counterpart of ``threshold_crypto_tpu/parallel/multihost.py``. The
protocol bytes still travel over the application's transport; this module
carries the data plane between the processes that together verify or
combine one batch, one device each.

Everything degrades to one process: ``initialize()`` does nothing when no
coordinator is configured, ``world()`` is then (0, 1), ``global_mesh()`` a
mesh of one, ``broadcast_bytes`` the identity and
``assert_equal_across_hosts`` a no-op.

``run_world`` starts a whole world of processes on this host (the tests'
gloo worlds on the CPU, ``chip_smoke.py``'s ranks on one card): each child
brings up the group, runs one function on its mesh, and prints its result;
the parent waits with a deadline and kills what is left.
"""

from __future__ import annotations

import datetime
import hashlib
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .mesh import SHARE_AXIS, default_device, make_mesh

# Seconds a collective (and the group's rendezvous) may wait for its peers.
TIMEOUT_S = 600
_device = None


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device="cuda",
               backend: str | None = None) -> bool:
    """Bring up the default process group (``init_method`` tcp://
    ``coordinator``, "host:port"); True when it spans several processes.

    Arguments default to the variables ``torchrun`` sets (MASTER_ADDR and
    MASTER_PORT, WORLD_SIZE, RANK); with no coordinator either way this is
    a no-op that returns False (world size 1). ``device`` "cuda" gives each
    rank ``cuda:{local rank % device count}``, "cpu" the CPU, another value
    that device. The backend follows the device, nccl for CUDA and gloo for
    the CPU, unless ``backend`` names one (gloo for several ranks that
    share one card, which nccl refuses)."""
    global _device
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if addr is None or port is None:
            return False
        coordinator = f"{addr}:{port}"
    n = num_processes if num_processes is not None else \
        os.environ.get("WORLD_SIZE")
    rank = process_id if process_id is not None else os.environ.get("RANK")
    if n is None or rank is None:
        raise ValueError("a coordinator needs num_processes and process_id "
                         "(or WORLD_SIZE and RANK)")
    n, rank = int(n), int(rank)
    dev = default_device(rank) if str(device) == "cuda" else \
        torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _device = dev
    return n > 1


def shutdown() -> None:
    """Destroy the process group, if there is one."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def world():
    """(process index, process count) of the current runtime."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(axis: str = SHARE_AXIS, device=None):
    """The mesh over every process of the group, one device each, on the
    device ``initialize`` chose (or ``device``)."""
    return make_mesh(axis=axis, device=device or _device)


def _collective_device():
    """Where a collective's tensors live: the card under nccl, else the
    CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_bytes(data: bytes | None, max_len: int = 1 << 20) -> bytes:
    """The dealer's broadcast of opaque protocol bytes (ciphertexts,
    commitments, public key sets) from process 0 to every process; each
    receiver deserializes with the validating codecs (``serde_impl``).

    One process: the identity. Several: an 8-byte length and the payload
    in a fixed uint8[max_len + 8] tensor, broadcast from rank 0. Rank 0
    raises ValueError without data or with more than max_len bytes, before
    any collective."""
    rank, n = world()
    if n <= 1:
        if data is None:
            raise ValueError("process 0 must supply data")
        return bytes(data)
    buf = np.zeros(max_len + 8, np.uint8)
    if rank == 0:
        if data is None:
            raise ValueError("process 0 must supply data")
        if len(data) > max_len:
            raise ValueError(f"payload {len(data)} exceeds max_len {max_len}")
        buf[:8] = np.frombuffer(len(data).to_bytes(8, "little"), np.uint8)
        buf[8: 8 + len(data)] = np.frombuffer(bytes(data), np.uint8)
    t = torch.from_numpy(buf).to(_collective_device())
    dist.broadcast(t, src=0)
    out = t.cpu().numpy()
    size = int.from_bytes(out[:8].tobytes(), "little")
    return out[8: 8 + size].tobytes()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _digest(tree) -> bytes:
    """SHA-256 over the dtype, shape and bytes of every leaf, in order."""
    h = hashlib.sha256()
    for leaf in _leaves(tree):
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) \
            else np.asarray(leaf)
        h.update(f"{arr.dtype}{arr.shape}".encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.digest()


def assert_equal_across_hosts(tree, name: str = "value") -> None:
    """Guard that replicated protocol state really is identical on every
    process: the digests of the tree's leaves are gathered, and every rank
    raises AssertionError if any differs."""
    if world()[1] <= 1:
        return
    mine = torch.frombuffer(bytearray(_digest(tree)), dtype=torch.uint8)
    mine = mine.to(_collective_device())
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    if any(not torch.equal(d, every[0]) for d in every):
        raise AssertionError(f"{name} diverged across hosts")


# ---------------------------------------------------------------------------
# A world of processes on this host
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_CHILD = ("import sys\n"
          "from threshold_crypto_tpu_torch.parallel import multihost\n"
          "sys.exit(multihost._child_main(sys.argv[1:]))\n")
_RESULT = "RESULT "
# Seconds the other ranks get to finish once one has failed.
_GRACE_S = 20


def _child_main(argv) -> int:
    """One rank of ``run_world``: bring up the group, run the target on
    the global mesh, print its JSON result; the group is destroyed on the
    way out, also when the target raises."""
    target, coordinator, n, rank, device, backend, kwargs = argv
    torch.set_num_threads(1)
    initialize(coordinator, int(n), int(rank), device=device,
               backend=backend or None)
    try:
        mod, fn = target.split(":")
        result = getattr(importlib.import_module(mod), fn)(
            global_mesh(), **json.loads(kwargs))
        print(_RESULT + json.dumps(result), flush=True)
    finally:
        shutdown()
    return 0


def run_world(target: str, n: int, *, device="cuda", backend=None,
              kwargs=None, timeout_s: float = 900, path=(),
              echo: bool = False) -> list:
    """Run ``target`` ("module:function", called as fn(mesh, **kwargs) and
    returning JSON data) in n child processes, ranks 0..n−1 of one group
    over a free localhost port; ``path`` is put on their sys.path beside
    this package. Returns the n results in rank order. Each child gets
    LOCAL_RANK = its rank and one CPU thread; ``device`` is each rank's
    ``initialize`` device, "cuda" (the default: ``cuda:{rank % device
    count}``, nccl unless ``backend`` says otherwise) or "cpu" (gloo),
    as for every entry point of the port. All children must exit 0
    before the deadline; else (or 20 s after one child fails) every child
    still running is killed and RuntimeError carries the tail of each
    one's output. echo: copy each
    child's output to stdout, each line after "[rank i] "."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root, *path] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                         else []))
    coordinator = f"localhost:{free_port()}"
    procs, logs = [], []
    try:
        for rank in range(n):
            log = tempfile.TemporaryFile(mode="w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _CHILD, target, coordinator, str(n),
                 str(rank), str(device), backend or "",
                 json.dumps(kwargs or {})],
                stdout=log, stderr=subprocess.STDOUT, text=True,
                env=dict(env, LOCAL_RANK=str(rank))))
        deadline = time.monotonic() + timeout_s
        expired, failed_at = False, None
        while True:
            codes = [p.poll() for p in procs]
            if None not in codes:
                break
            now = time.monotonic()
            if failed_at is None and any(codes):
                failed_at = now
            if failed_at is not None and now - failed_at > _GRACE_S:
                break                       # a peer failed: stop the rest
            if now > deadline:
                expired = True
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    if echo:
        for rank, out in enumerate(outs):
            for line in out.splitlines():
                if not line.startswith(_RESULT):
                    print(f"[rank {rank}] {line}", flush=True)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if expired or bad:
        what = f"timed out after {timeout_s} s" if expired else \
            f"ranks {bad} failed"
        raise RuntimeError(f"{target} in a world of {n}: {what}\n" + "\n".join(
            f"--- rank {r} (exit {p.returncode}) ---\n{outs[r][-3000:]}"
            for r, p in enumerate(procs)))
    results = []
    for rank, out in enumerate(outs):
        lines = [ln for ln in out.splitlines() if ln.startswith(_RESULT)]
        if not lines:
            raise RuntimeError(f"rank {rank} of {target} printed no result")
        results.append(json.loads(lines[-1][len(_RESULT):]))
    return results
