"""Hamiltonian / conformal-Hamiltonian trajectory integration.

One integrator serves both HMC and GRAHMC: the conformal leapfrog with
friction gamma(t) == 0 is exactly the standard leapfrog (the momentum scaling
exp(-gamma eps / 2) becomes 1), so HMC is the friction-free special case.

Substep structure (behavioral parity: reference GRAHMC.py:151-211 /
HMC.py:85-134):
    p *= exp(-gamma_t eps/2)         [friction; skipped for HMC]
    p += (eps/2) grad log p(q)
    q += eps * (p * inv_mass)
    lp, grad = target(q)             [the hot op: 1 fused eval per substep]
    p += (eps/2) grad
    p *= exp(-gamma_t eps/2)

The XLA path is a lax.scan over substeps on (n_chains, n_dim) blocks; the
Pallas path (mcmc_tpu.ops) fuses the whole trajectory + MH accept into one
kernel.
"""

from typing import Callable, Optional, Tuple

import jax.numpy as jnp
from jax import lax, random

Array = jnp.ndarray

# The metric is DIAGONAL (inv_mass_matrix shape (D,), the reference's only
# mode) or DENSE (shape (D, D), a full inverse mass matrix — a beyond-
# reference extension matching Stan's dense_e). Dense velocity/whitening
# are (C, D) @ (D, D) matmuls, small next to the per-substep gradient at
# the D <= ~100 dims this library targets. The fused trajectory kernel
# (ops/fused_trajectory.py) takes the dense M^{-1} as an operand.


def velocity(p: Array, inv_mass_matrix: Array) -> Array:
    """dq/dt = M^{-1} p per chain: elementwise for a diagonal metric,
    one matmul for a dense one (M^{-1} is symmetric, so p @ M^{-1} works
    for both (C, D) batches and single-chain (D,) vectors)."""
    if inv_mass_matrix.ndim == 2:
        return p @ inv_mass_matrix
    return p * inv_mass_matrix


def kinetic_energy(p: Array, inv_mass_matrix: Array) -> Array:
    """0.5 * p^T M^{-1} p per chain."""
    return 0.5 * jnp.sum(p * velocity(p, inv_mass_matrix), axis=-1)


def sample_momentum(key, shape, inv_mass_matrix: Array, dtype) -> Array:
    """p ~ N(0, M) with M = inv_mass_matrix^{-1}.

    Diagonal: z / sqrt(M^{-1}). Dense: with M^{-1} = L L^T (Cholesky),
    p = L^{-T} z has covariance L^{-T} L^{-1} = M; the triangular solve is
    loop-invariant in the samplers' scans, so XLA hoists the factorization
    out of the hot loop."""
    z = random.normal(key, shape, dtype=dtype)
    if inv_mass_matrix.ndim == 2:
        from jax.scipy.linalg import solve_triangular
        L = jnp.linalg.cholesky(inv_mass_matrix.astype(dtype))
        # solve L^T p^T = z^T  (batched over chains via the trailing axis)
        return solve_triangular(L, z.T, lower=True, trans="T").T
    return z / jnp.sqrt(inv_mass_matrix)


def integrate_trajectory(
    q: Array,
    p: Array,
    lp: Array,
    grad: Array,
    value_and_grad: Callable,
    step_size,
    num_steps: int,
    inv_mass_matrix: Array,
    friction_schedule: Optional[Callable] = None,
    gamma_max=None,
    steepness=None,
) -> Tuple[Array, Array, Array, Array]:
    """Integrate num_steps (conformal) leapfrog steps for all chains.

    friction_schedule: None for plain HMC, else a (t, T, gamma_max, steepness)
    -> gamma function evaluated at t = i * eps with T = L * eps (parity with
    reference GRAHMC.py:246-252).

    Returns (q, p, lp, grad) after the trajectory.
    """
    pos_dtype = q.dtype
    e_dtype = lp.dtype
    eps = jnp.asarray(step_size, pos_dtype)
    half_eps = 0.5 * eps
    total_time = eps * num_steps

    def substep(carry, i):
        q, p, lp, grad = carry
        if friction_schedule is not None:
            # midpoint friction grid t = (i + 1/2) eps: the i*eps grid the
            # reference uses (GRAHMC.py:246-252) breaks antisymmetry
            # discretely (sum gamma_i = -gamma_max instead of 0), so the
            # conformal map expands phase volume by e^{+eps*gamma*D} per
            # trajectory with no Jacobian in the MH test AND loses the
            # reversal involution — a real stationary bias (measured: var
            # 4.33 on N(0,I) at eps=.5, gamma=.5, L=8, accept 0.043).
            # Midpoints pair i <-> L-1-i exactly about T/2: volume-neutral,
            # involutive, plain exp(-dH) acceptance exact (var 0.994,
            # accept 0.619 at the same operating point). PARITY.md.
            gamma_t = friction_schedule(
                (i.astype(pos_dtype) + 0.5) * eps, total_time,
                jnp.asarray(gamma_max, pos_dtype),
                jnp.asarray(steepness, pos_dtype))
            scale = jnp.exp(-gamma_t * half_eps)
            p = p * scale
        p = p + half_eps * grad
        q = q + eps * velocity(p, inv_mass_matrix)
        new_lp, new_grad = value_and_grad(q)
        new_lp = new_lp.astype(e_dtype)
        new_grad = new_grad.astype(pos_dtype)
        p = p + half_eps * new_grad
        if friction_schedule is not None:
            p = p * scale
        return (q, p, new_lp, new_grad), None

    (q, p, lp, grad), _ = lax.scan(substep, (q, p, lp, grad),
                                   jnp.arange(num_steps))
    return q, p, lp, grad


def integrate_trajectory_dynamic(
    q: Array,
    p: Array,
    lp: Array,
    grad: Array,
    value_and_grad: Callable,
    step_size,
    num_steps,
    inv_mass_matrix: Array,
    friction_schedule: Optional[Callable] = None,
    gamma_max=None,
    steepness=None,
) -> Tuple[Array, Array, Array, Array]:
    """Same substep structure as `integrate_trajectory`, but `num_steps` may
    be a TRACED scalar (lowers to `lax.while_loop`) — the trip count is
    decided at run time, shared by all chains.

    This exists for jittered-trajectory samplers (ChEES tuning, tuning/
    chees.py): each iteration integrates t = h * T time which quantizes to a
    different leapfrog count, while the per-substep work stays a dense
    (n_chains, n_dim) block. A scan cannot express this (static length);
    padding to a max length and masking would waste the masked substeps'
    gradient evaluations — the dominant cost.

    The friction schedule (GRAHMC) is evaluated against the traced total
    time T = num_steps * eps, so the repel->attract switch stays centered
    on the realized trajectory.
    """
    pos_dtype = q.dtype
    e_dtype = lp.dtype
    eps = jnp.asarray(step_size, pos_dtype)
    half_eps = 0.5 * eps
    n = jnp.asarray(num_steps, jnp.int32)
    total_time = eps * n.astype(pos_dtype)

    def body(i, carry):
        q, p, lp, grad = carry
        if friction_schedule is not None:
            # midpoint friction grid — see integrate_trajectory above
            gamma_t = friction_schedule(
                (i.astype(pos_dtype) + 0.5) * eps, total_time,
                jnp.asarray(gamma_max, pos_dtype),
                jnp.asarray(steepness, pos_dtype))
            scale = jnp.exp(-gamma_t * half_eps)
            p = p * scale
        p = p + half_eps * grad
        q = q + eps * velocity(p, inv_mass_matrix)
        new_lp, new_grad = value_and_grad(q)
        new_lp = new_lp.astype(e_dtype)
        new_grad = new_grad.astype(pos_dtype)
        p = p + half_eps * new_grad
        if friction_schedule is not None:
            p = p * scale
        return (q, p, new_lp, new_grad)

    q, p, lp, grad = lax.fori_loop(0, n, body, (q, p, lp, grad))
    return q, p, lp, grad


def mh_transition_dynamic(key, state, value_and_grad, step_size, n_leapfrogs,
                          inv_mass_matrix, friction_schedule=None,
                          gamma_max=0.0, steepness=1.0):
    """One full MH transition whose leapfrog count is a TRACED value.

    The single implementation of the jittered dynamic-length transition
    shared by the ChEES warmup and sampler (tuning/chees.py) and the
    ChEES-tuned SMC moves (samplers/smc.py) — the accept rule, the
    |dH| > 1000 divergence criterion, the non-finite-energy reject guard,
    and the unflipped-endpoint-momentum contract (the ChEES criterion
    derivative needs dq/dt AT the endpoint, before any reversibility
    flip) live here exactly once.

    RNG contract: consumes key as (key, k_mom, k_acc) = split(key, 3);
    momentum from k_mom, the accept uniform from k_acc — bit-identical to
    the previous inline copies at every call site.

    Returns (key, new_state, accept_mask, q1, p1_unflipped, log_alpha,
    divergent): q1/p1 the trajectory endpoint, log_alpha the per-chain MH
    log acceptance probability (alpha = exp(log_alpha) is the ChEES
    weight), divergent the per-chain |dH| flag already accumulated into
    new_state.divergence_count.
    """
    from mcmc_tpu import precision
    from mcmc_tpu.diagnostics.gates import DIVERGENCE_DELTA_H

    pos_dtype = state.position.dtype
    e_dtype = state.log_prob.dtype
    key, k_mom, k_acc = random.split(key, 3)
    p0 = sample_momentum(k_mom, state.position.shape, inv_mass_matrix,
                         pos_dtype)
    h0 = -state.log_prob + kinetic_energy(p0, inv_mass_matrix).astype(e_dtype)
    q1, p1, lp1, grad1 = integrate_trajectory_dynamic(
        state.position, p0, state.log_prob, state.grad_log_prob,
        value_and_grad, step_size, n_leapfrogs, inv_mass_matrix,
        friction_schedule=friction_schedule, gamma_max=gamma_max,
        steepness=steepness)
    h1 = -lp1 + kinetic_energy(p1, inv_mass_matrix).astype(e_dtype)
    finite = jnp.isfinite(h1)
    h1 = precision.guard_energy(h1)
    log_alpha = jnp.minimum(jnp.asarray(0.0, e_dtype), h0 - h1)
    divergent = jnp.abs(h1 - h0) > DIVERGENCE_DELTA_H
    u = precision.accept_uniform(k_acc, (state.position.shape[0],),
                                 e_dtype)
    accept = finite & (jnp.log(u) < log_alpha)
    new_state = state._replace(
        position=jnp.where(accept[:, None], q1, state.position),
        log_prob=jnp.where(accept, lp1, state.log_prob),
        grad_log_prob=jnp.where(accept[:, None], grad1,
                                state.grad_log_prob),
        accept_count=state.accept_count + accept.astype(jnp.int32),
        divergence_count=(state.divergence_count
                          + divergent.astype(jnp.int32)))
    return key, new_state, accept, q1, p1, log_alpha, divergent
