"""Welford online mean/variance estimation, vectorized over chains.

The reference keeps a Python list of per-chain Welford states and updates them
in a nested host loop over samples and chains (reference tuning/adaptation.py:
229-235, tuning/welford.py). Here the state is a single (n_chains, dim) array
pytree updated by fused device ops, so per-chain estimation (Stan's approach)
costs one vector op per sample — and lives happily inside lax.scan carries.
"""

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax


class WelfordState(NamedTuple):
    """Running statistics. Leading axes of mean/m2 are arbitrary batch axes
    (typically (n_chains, dim)); count is shared across the batch."""
    count: jnp.ndarray  # scalar
    mean: jnp.ndarray
    m2: jnp.ndarray


def welford_init(shape, dtype=None) -> WelfordState:
    """Initialize. shape may be an int (dim) or a tuple ((n_chains, dim)).

    Default dtype: float64 under x64 (reference parity), float32 on the
    accelerator path."""
    if isinstance(shape, int):
        shape = (shape,)
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    return WelfordState(
        count=jnp.zeros((), dtype),
        mean=jnp.zeros(shape, dtype),
        m2=jnp.zeros(shape, dtype),
    )


@jax.jit
def welford_update(state: WelfordState, x: jnp.ndarray) -> WelfordState:
    """Add one observation (batched over leading axes of the state)."""
    x = x.astype(state.mean.dtype)
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(count, mean, m2)


@jax.jit
def welford_update_batch(state: WelfordState, batch: jnp.ndarray) -> WelfordState:
    """Add a batch of observations (leading axis = time) via scan."""
    def body(s, x):
        return welford_update(s, x), None
    final, _ = lax.scan(body, state, batch)
    return final


@jax.jit
def welford_covariance(state: WelfordState) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(mean, sample variance m2/(n-1)) with a count floor of 2."""
    n = jnp.maximum(state.count, 2.0)
    return state.mean, state.m2 / (n - 1.0)


@jax.jit
def chain_averaged_variance(state: WelfordState) -> jnp.ndarray:
    """Stan-style estimate for (n_chains, dim) states: per-chain variances
    averaged over chains (reference adaptation.py:242-248). Returns (dim,)."""
    _, var = welford_covariance(state)
    return jnp.mean(var, axis=0)


@jax.jit
def shrink_variance(variance: jnp.ndarray, n_samples) -> jnp.ndarray:
    """Stan's regularization toward the identity metric:
    n/(n+5) * var + 5/(n+5) * 1.0, floored at 1e-8
    (reference adaptation.py:257-262)."""
    w = n_samples / (n_samples + 5.0)
    reg = w * variance + (1.0 - w) * 1.0
    return jnp.maximum(reg, 1e-8)


class DenseMomentState(NamedTuple):
    """Pooled second-moment accumulator for DENSE metric estimation
    (beyond-reference: Stan's dense_e). Draws are pooled over chains and
    steps; `center` is a fixed shift (the window-start position mean) that
    bounds float32 cancellation without changing the covariance."""
    count: jnp.ndarray    # scalar: pooled draw count (chains x steps)
    center: jnp.ndarray   # (dim,)
    sum_d: jnp.ndarray    # (dim,) sum of centered draws
    sum_o: jnp.ndarray    # (dim, dim) sum of centered outer products


def dense_moment_init(center) -> DenseMomentState:
    center = jnp.asarray(center)
    d = center.shape[-1]
    return DenseMomentState(
        count=jnp.zeros((), center.dtype),
        center=center,
        sum_d=jnp.zeros((d,), center.dtype),
        sum_o=jnp.zeros((d, d), center.dtype))


def psum_increment(new, old, axis_name: str):
    """Globalize a replicated-carry update under shard_map: each device
    computed `new` from its LOCAL chain shard; psum the increment so the
    carry stays bit-identical on every device (new == old + local delta,
    so old + psum(delta) is the pooled update)."""
    return jax.tree.map(
        lambda a, b: b + lax.psum(a - b, axis_name), new, old)


def dense_moment_update(state: DenseMomentState,
                        positions: jnp.ndarray) -> DenseMomentState:
    """Accumulate a (n_chains, dim) batch of draws (one matmul)."""
    d = positions.astype(state.center.dtype) - state.center
    return state._replace(
        count=state.count + d.shape[0],
        sum_d=state.sum_d + jnp.sum(d, axis=0),
        sum_o=state.sum_o + d.T @ d)


def dense_covariance(state: DenseMomentState) -> jnp.ndarray:
    """Pooled sample covariance (dim, dim)."""
    n = jnp.maximum(state.count, 2.0)
    mu = state.sum_d / n
    return state.sum_o / n - jnp.outer(mu, mu)


@jax.jit
def shrink_covariance(cov: jnp.ndarray, n_samples) -> jnp.ndarray:
    """Stan's dense-metric regularization toward the identity:
    n/(n+5) * cov + 5/(n+5) * I, plus a 1e-8 diagonal jitter so the
    Cholesky in sample_momentum never sees a semidefinite matrix."""
    w = n_samples / (n_samples + 5.0)
    d = cov.shape[-1]
    eye = jnp.eye(d, dtype=cov.dtype)
    return w * cov + ((1.0 - w) + 1e-8) * eye
