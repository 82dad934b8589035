"""Chain parallelism over a device mesh.

MCMC chains are embarrassingly parallel: zero communication in the sampling
hot loop, cross-chain reductions only in diagnostics (SURVEY.md §2 parallelism
inventory). The scaling story is therefore pure GSPMD data parallelism over
the chain axis:

- build a 1-D Mesh over all devices with axis 'chains',
- shard every (n_chains, ...) array with NamedSharding(P('chains', ...)),
- jit the run function; XLA partitions the whole scan (the counter-based
  threefry PRNG is partitionable, so even momentum sampling shards cleanly),
- diagnostics reductions over the sharded history lower to psum/all-gather
  collectives automatically (NCCL on GPUs).

No shard_map is needed for the samplers — there is nothing to communicate.
``constrain_chains`` inserts explicit sharding constraints when XLA's
propagation needs anchoring (e.g. inside custom pipelines).
"""

from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# Counter-based RNG partitioning: each device generates only its slice of
# random arrays. Required for chain-sharded momentum sampling to scale.
jax.config.update("jax_threefry_partitionable", True)

CHAIN_AXIS = "chains"


def make_mesh(n_devices: Optional[int] = None, axis_name: str = CHAIN_AXIS) -> Mesh:
    """1-D device mesh over the chain axis (all visible devices by default)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def chain_sharding(mesh: Mesh, ndim: int, axis_name: str = CHAIN_AXIS) -> NamedSharding:
    """NamedSharding putting the leading (chain) axis across the mesh."""
    return NamedSharding(mesh, P(axis_name, *([None] * (ndim - 1))))


def shard_chains(tree, mesh: Mesh, axis_name: str = CHAIN_AXIS):
    """device_put every array in the pytree with its leading axis sharded
    across the mesh (scalars and rank-0 leaves are replicated)."""
    def put(x):
        x = jnp.asarray(x)
        if x.ndim == 0:
            return jax.device_put(x, NamedSharding(mesh, P()))
        return jax.device_put(x, chain_sharding(mesh, x.ndim, axis_name))
    return jax.tree_util.tree_map(put, tree)


def constrain_chains(x, axis_name: str = CHAIN_AXIS):
    """In-jit sharding constraint: leading axis over the chain mesh axis."""
    spec = P(axis_name, *([None] * (jnp.ndim(x) - 1)))
    return jax.lax.with_sharding_constraint(x, spec)


def replicate(tree, mesh: Mesh):
    """device_put a pytree fully replicated on the mesh."""
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(jnp.asarray(x), NamedSharding(mesh, P())), tree)


def shard_map_fn(f, mesh: Mesh, in_specs, out_specs):
    """`jax.shard_map` with replication checking disabled (pallas_call
    outputs carry no vma annotations). Every shard_map site in the package
    (fused samplers, mesh warmup, sequential tuner, sharded diagnostics)
    goes through here."""
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)
