"""Sliced Wasserstein-2 distance as a single fused device computation.

The reference computes this on host in Python-loop batches of projections
(reference benchmarks/metrics.py:12-145). Here the projection step is one
matmul (n, dim) @ (dim, P) — followed by ``jax.lax.sort`` along the
sample axis, all inside one jit. Batched projections are kept as an option for
very large sample sets, but the default is a single fused call.

Protocol parity (reference metrics.py / run_benchmarks.py:817-820):
500 random unit projections, quantile matching when sample counts differ,
W2 = sqrt(mean((q1 - q2)^2)) per projection, mean over projections;
``compute_sliced_w2`` flattens chains, draws 50k reference samples, subsamples
the MCMC side if larger.
"""

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import random


def _unshard(x: jnp.ndarray) -> jnp.ndarray:
    """Collapse a mesh-sharded sample set onto one device before sorting.

    The W2 protocol sorts every projection along the flattened sample axis.
    On a history sharded over chains (mesh runs), that axis is distributed,
    and GSPMD lowers each of the 500 projected sorts to a global multi-device
    sort — measured 257s vs 24s on the 8-virtual-device CPU mesh for the
    standard protocol, and an all-to-all storm across devices. The sample sets
    here are protocol-capped (50k rows x dim), so one explicit gather to a
    single device is strictly cheaper than any distributed sort. No-op for
    single-device arrays.
    """
    x = jnp.asarray(x)
    if isinstance(x, jax.Array) and len(x.devices()) > 1:
        x = jax.device_put(x, next(iter(x.devices())))
    return x


@partial(jax.jit, static_argnames=("n_quantiles",))
def _sliced_w2_batch(samples1, samples2, directions, n_quantiles: int):
    """W2 per projection for one batch of unit directions: (P,)."""
    proj1 = samples1 @ directions.T          # (n1, P)
    proj2 = samples2 @ directions.T          # (n2, P)
    s1 = jnp.sort(proj1, axis=0)
    s2 = jnp.sort(proj2, axis=0)
    n1, n2 = s1.shape[0], s2.shape[0]
    if n1 != n2:
        q = jnp.linspace(0.0, 1.0, n_quantiles)
        s1 = jnp.quantile(s1, q, axis=0)
        s2 = jnp.quantile(s2, q, axis=0)
    return jnp.sqrt(jnp.mean((s1 - s2) ** 2, axis=0))


def sliced_wasserstein_distance(
    samples1: jnp.ndarray,
    samples2: jnp.ndarray,
    n_projections: int = 500,
    key: Optional[jnp.ndarray] = None,
    projection_batch_size: int = 500,
) -> float:
    """Sliced W2 between two sample sets (n_i, dim).

    Protocol matches the reference (metrics.py:12-84), including the fixed
    default key and per-batch ``fold_in`` direction keys, but runs fused on
    device. ``projection_batch_size`` defaults to all-at-once; reduce it for
    very large sample sets.
    """
    if key is None:
        key = random.PRNGKey(30)

    samples1 = _unshard(samples1)
    samples2 = _unshard(samples2)
    n1, dim = samples1.shape
    n2 = samples2.shape[0]
    n_quantiles = min(n1, n2)

    w2_all = []
    n_batches = (n_projections + projection_batch_size - 1) // projection_batch_size
    for batch_idx in range(n_batches):
        size = min(projection_batch_size, n_projections - batch_idx * projection_batch_size)
        batch_key = random.fold_in(key, batch_idx)
        directions = random.normal(batch_key, (size, dim))
        directions = directions / jnp.linalg.norm(directions, axis=1, keepdims=True)
        w2_all.append(_sliced_w2_batch(samples1, samples2, directions, n_quantiles))

    return float(jnp.mean(jnp.concatenate(w2_all)))


def _quantiles_of_sorted(s: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Linear-interpolated quantiles of an ALREADY-SORTED (n, P) matrix.

    Same interpolation as jnp.quantile's default (pos = q*(n-1), linear),
    but skips its internal re-sort — the point of caching sorted reference
    projections across convergence checkpoints.
    """
    n = s.shape[0]
    pos = q * (n - 1)
    lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, n - 1)
    hi = jnp.clip(lo + 1, 0, n - 1)
    frac = (pos - lo)[:, None]
    return s[lo] * (1.0 - frac) + s[hi] * frac


@partial(jax.jit, static_argnames=("n_quantiles",))
def _w2_vs_sorted_ref(samples, ref_sorted, directions, n_quantiles: int):
    """Mean per-projection W2 of samples vs cached sorted reference."""
    s1 = jnp.sort(samples @ directions.T, axis=0)      # (n1, P)
    if s1.shape[0] != ref_sorted.shape[0]:
        q = jnp.linspace(0.0, 1.0, n_quantiles)
        s1 = _quantiles_of_sorted(s1, q)
        s2 = _quantiles_of_sorted(ref_sorted, q)
    else:
        s2 = ref_sorted
    return jnp.mean(jnp.sqrt(jnp.mean((s1 - s2) ** 2, axis=0)))


class ConvergenceW2Tracker:
    """Amortized sliced-W2 for convergence traces.

    The full protocol (fresh reference draw + fresh directions + an
    (n_ref, P) sort, reference metrics.py:87-145) is re-paid at EVERY
    checkpoint of a tracked run — the (50000, 500) reference-side sort
    dominates (~24s/checkpoint on the CPU test host) and its result never
    changes within a run. This tracker draws the reference set and the
    direction set ONCE, caches the sorted reference projections, and each
    checkpoint pays only its own sample projection + sort. Fixed
    directions also remove direction-resampling noise from the trace, so
    checkpoints are directly comparable. The headline ``sliced_w2`` of the
    finished run still uses the fresh-draw parity path
    (:func:`compute_sliced_w2`).
    """

    def __init__(self, target_name: str, dim: int, n_reference: int = 50000,
                 n_projections: int = 500, key: Optional[jnp.ndarray] = None,
                 **target_kwargs):
        from mcmc_tpu.targets import get_reference_sampler
        self.ok = False
        ref_sampler = get_reference_sampler(target_name, dim, **target_kwargs)
        if ref_sampler is None:
            return
        if key is None:
            key = random.PRNGKey(123)
        k_ref, k_dir, self._sub_key = random.split(key, 3)
        ref = _unshard(ref_sampler(k_ref, n_reference))
        dirs = random.normal(k_dir, (n_projections, dim))
        self._dirs = dirs / jnp.linalg.norm(dirs, axis=1, keepdims=True)
        self._ref_sorted = jnp.sort(ref @ self._dirs.T, axis=0)  # (n_ref, P)
        self._n_ref = n_reference
        self.ok = True

    def w2(self, samples: jnp.ndarray) -> Optional[float]:
        """Sliced W2 of (draws, chains, dim) or (n, dim) samples, or None."""
        if not self.ok:
            return None
        dim = samples.shape[-1]
        flat = samples.reshape(-1, dim) if samples.ndim == 3 else samples
        if flat.shape[0] > self._n_ref:
            self._sub_key, k = random.split(self._sub_key)
            idx = random.choice(k, flat.shape[0], (self._n_ref,),
                                replace=False)
            flat = flat[idx]
        flat = _unshard(flat)
        n_q = min(flat.shape[0], self._n_ref)
        return float(_w2_vs_sorted_ref(flat, self._ref_sorted, self._dirs,
                                       n_q))


def compute_sliced_w2(
    samples: jnp.ndarray,
    target_name: str,
    dim: int,
    n_reference: int = 50000,
    n_projections: int = 500,
    projection_batch_size: int = 500,
    key: Optional[jnp.ndarray] = None,
    **target_kwargs,
) -> Optional[float]:
    """Sliced W2 between MCMC samples and exact ground truth, or None.

    Parity: reference metrics.py:87-145. samples may be (num_samples, n_chains,
    dim) or (n, dim).
    """
    from mcmc_tpu.targets import get_reference_sampler

    if key is None:
        key = random.PRNGKey(123)

    ref_sampler = get_reference_sampler(target_name, dim, **target_kwargs)
    if ref_sampler is None:
        return None

    flat = samples.reshape(-1, dim) if samples.ndim == 3 else samples
    n_samples = flat.shape[0]

    key, subkey = random.split(key)
    reference_samples = ref_sampler(subkey, n_reference)

    if n_samples > n_reference:
        key, subkey = random.split(key)
        idx = random.choice(subkey, n_samples, (n_reference,), replace=False)
        flat = flat[idx]

    key, subkey = random.split(key)
    return sliced_wasserstein_distance(
        flat, reference_samples,
        n_projections=n_projections,
        projection_batch_size=projection_batch_size,
        key=subkey,
    )
