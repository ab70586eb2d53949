"""The share batch over several processes, one device each.

`parallel.mesh`      — the mesh of a process group, placement helpers.
`parallel.sharded`   — sign / verify per block (no collectives), and the
                       combine and RLC aggregate as per-rank partial MSMs
                       gathered and folded.
`parallel.multihost` — ``torch.distributed`` bring-up, the global mesh,
                       the dealer's broadcast of protocol bytes, and worlds
                       of processes on one host.
`parallel.dryrun`    — ``dryrun_multichip``: sign, verify, combine and the
                       sharded RLC check, one share per rank.

The counterpart of ``threshold_crypto_tpu/parallel``: the same names, and
``gather_batch`` beside them.
"""

from . import mesh  # noqa: F401
from . import multihost  # noqa: F401
from . import sharded  # noqa: F401

from .mesh import (  # noqa: F401
    SHARE_AXIS,
    batch_spec,
    gather_batch,
    make_mesh,
    repl_spec,
    replicate,
    shard_batch,
)
from .sharded import (  # noqa: F401
    sharded_combine,
    sharded_rlc_aggregate,
    sharded_sign,
    sharded_verify,
    sharded_verify_rlc,
)
