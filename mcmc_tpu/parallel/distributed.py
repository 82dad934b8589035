"""Multi-host initialization and the global chain mesh.

The reference is strictly single-process/single-device (SURVEY.md §5:
"Distributed communication backend: none"); this module is the scale-out
tier above it. Chains are communication-free during sampling, so a
multi-host run is pure data parallelism over the chain axis:

- within a host: chains shard over the host's GPUs (NVLink),
- across hosts: more chain shards; the only cross-host traffic is the
  diagnostics reductions at the end (psum/all_gather of moment
  accumulators — bytes, not histories).

`initialize()` wraps `jax.distributed.initialize` (no-op when single
process); `make_chain_mesh()` builds a 1-D global chain mesh over all
devices of all hosts in process-major order, so each host's devices hold
contiguous chain shards.
"""

import os
from typing import Optional

import jax
from jax.sharding import Mesh

from mcmc_tpu.parallel import CHAIN_AXIS

# Environment evidence that this process is part of a multi-host job. When
# any of these are set, a failed argument-free initialize() must NOT fall
# back to single-process: each host would silently run an independent
# duplicate job (process_count() is still 1 after a FAILED initialize, so
# it cannot distinguish 'single machine' from 'coordinator unreachable').
# Only explicit coordinator addresses qualify: other cluster variables are
# also set on single-host machines, so they are not evidence of a
# multi-host job.
_DIST_ENV_HINTS = (
    "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
    "MEGASCALE_COORDINATOR_ADDRESS",
)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> int:
    """Initialize the multi-host runtime; returns the local process index.

    With no arguments, uses JAX's cluster auto-detection (which needs a
    cluster environment; on a plain multi-GPU host pass coordinator_address
    ('localhost:<port>'), num_processes and process_id); explicitly a no-op
    in single-process settings so call sites can run unchanged on one
    host.
    """
    if num_processes is not None and num_processes <= 1:
        return 0
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except (ValueError, RuntimeError) as e:
        # Only two cases may proceed: the runtime is already initialized, or
        # this is an argument-free call on a machine with NO environment
        # evidence of a multi-host job (no coordinator address configured
        # anywhere). Both checks are structural — neither depends on JAX's
        # exception wording except the secondary already-initialized match.
        # Explicit-argument failures, and no-args failures under a
        # configured coordinator environment (e.g. a transient network error on
        # a GKE pod), always re-raise: swallowing them would leave every
        # host silently running an independent single-process job.
        already = "already" in str(e).lower()
        no_args = (coordinator_address is None and num_processes is None
                   and process_id is None)
        dist_env = any(os.environ.get(v) for v in _DIST_ENV_HINTS)
        if not (already or (no_args and not dist_env)):
            raise
    return jax.process_index()


def make_chain_mesh(axis_name: str = CHAIN_AXIS) -> Mesh:
    """Global 1-D chain mesh over every device of every process.

    jax.devices() is process-major, so each process's devices are
    contiguous chain shards; one named axis because chains are the only
    parallel dimension in MCMC (SURVEY.md §2 parallelism inventory).
    """
    return Mesh(jax.devices(), (axis_name,))
