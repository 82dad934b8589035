"""GRAHMC: Generalized Repelling-Attracting HMC with time-varying friction.

Behavioral parity with reference samplers/GRAHMC.py: conformal leapfrog
(friction scaling around the kick-drift-kick core), five gamma(t) schedules
transitioning from -gamma (repelling) to +gamma (attracting), momentum flip,
non-finite-Hamiltonian reject guard, float-energy MH test, burn-in counter
reset, optional proposal tracking for ESJD.

Based on "Repelling-Attracting Hamiltonian Monte Carlo" (Vishwanath & Tak,
2024); the constant schedule is the original RAHMC.

Differences from the reference: batched analytic target gradients, real
divergence counting (|dH| > 1000), and a fused trajectory kernel
(mcmc_tpu.ops.fused_trajectory) that backend='auto' selects on a GPU for
targets with kernel math (ops/padded_targets.resolve_backend).
"""

from functools import partial
from typing import Callable, Dict, Optional

import jax.numpy as jnp
from jax import jit, random

from mcmc_tpu import precision
from mcmc_tpu.ops.fused_trajectory import (make_fused_grahmc_step,
                                           prepare_dense_metric)
from mcmc_tpu.ops.padded_targets import resolve_backend
from mcmc_tpu.samplers.base import (
    ChainState, RunResult, init_chain_state, make_value_and_grad,
    run_sampler, finalize_run,
)
from mcmc_tpu.samplers.trajectory import (integrate_trajectory, kinetic_energy,
                                           sample_momentum)
from mcmc_tpu.diagnostics.gates import DIVERGENCE_DELTA_H

Array = jnp.ndarray

# ============================================================================
# Friction schedules gamma(t): -gamma_max -> +gamma_max over the trajectory.
# Signature (t, T, gamma_max, steepness); parity: reference GRAHMC.py:69-122.
# ============================================================================

def constant_schedule(t, T, gamma, steepness=None):
    """Original RAHMC step schedule: -gamma for t < T/2, +gamma after —
    and exactly 0 AT T/2, so an odd-length trajectory on the midpoint
    evaluation grid (samplers/trajectory.py) stays volume-neutral (its
    middle substep lands exactly on T/2)."""
    return jnp.where(t < T / 2, -gamma, jnp.where(t > T / 2, gamma, 0.0))


def tanh_schedule(t, T, gamma_max, steepness=5.0):
    """Smooth tanh transition; steepness controls the switch sharpness."""
    return gamma_max * jnp.tanh(steepness * (2.0 * t / T - 1.0))


def sigmoid_schedule(t, T, gamma_max, steepness=10.0):
    """Sigmoid transition mapped to (-gamma_max, +gamma_max)."""
    z = steepness * (t / T - 0.5)
    return gamma_max * (2.0 / (1.0 + jnp.exp(-z)) - 1.0)


def linear_schedule(t, T, gamma_max, steepness=None):
    """Linear ramp."""
    return gamma_max * (2.0 * t / T - 1.0)


def sine_schedule(t, T, gamma_max, steepness=None):
    """Sinusoidal ramp."""
    return gamma_max * jnp.sin(jnp.pi * (t / T - 0.5))


FRICTION_SCHEDULES: Dict[str, Callable] = {
    "constant": constant_schedule,
    "tanh": tanh_schedule,
    "sigmoid": sigmoid_schedule,
    "linear": linear_schedule,
    "sine": sine_schedule,
}


def get_friction_schedule(schedule_type: str) -> Callable:
    return FRICTION_SCHEDULES[schedule_type]


# Static sentinel: run the trajectory with NO friction at all (true HMC path —
# the exp()/multiply substeps are never emitted, unlike a zero-valued gamma).
NO_FRICTION = "no_friction"


def default_steepness(schedule_type: str) -> float:
    """Ablation-informed defaults (reference run_benchmarks.py:537-538)."""
    return 0.5 if schedule_type == "tanh" else 2.0


# ============================================================================
# Sampler
# ============================================================================

def grahmc_init(init_position, log_prob_fn, value_and_grad_fn=None) -> ChainState:
    return init_chain_state(init_position, log_prob_fn, value_and_grad_fn,
                            needs_grad=True)


def grahmc_step(key, state: ChainState, value_and_grad, step_size, num_steps: int,
                gamma, steepness, inv_mass_matrix,
                friction_schedule: Optional[Callable] = None):
    """One GRAHMC (or HMC when friction_schedule is None and gamma unused) step.

    Returns (key, new_state, extras) with extras = (accept, proposal_q,
    proposal_lp, delta_H).
    """
    n_chains, n_dim = state.position.shape
    pos_dtype = state.position.dtype
    e_dtype = state.log_prob.dtype

    key, k_mom, k_acc = random.split(key, 3)

    # p ~ N(0, M): diagonal metric scales N(0, I) by 1/sqrt(M^{-1}); a
    # dense (D, D) metric draws via the Cholesky of M^{-1} (trajectory.py)
    p0 = sample_momentum(k_mom, (n_chains, n_dim), inv_mass_matrix, pos_dtype)
    h0 = -state.log_prob + kinetic_energy(p0, inv_mass_matrix).astype(e_dtype)

    q, p, lp, grad = integrate_trajectory(
        state.position, p0, state.log_prob, state.grad_log_prob,
        value_and_grad, step_size, num_steps, inv_mass_matrix,
        friction_schedule=friction_schedule, gamma_max=gamma, steepness=steepness,
    )

    p = -p  # momentum flip for reversibility
    h1 = -lp + kinetic_energy(p, inv_mass_matrix).astype(e_dtype)
    finite = jnp.isfinite(h1)
    h1 = precision.guard_energy(h1)

    log_alpha = h0 - h1
    delta_h = h1 - h0
    divergent = jnp.abs(delta_h) > DIVERGENCE_DELTA_H

    u = precision.accept_uniform(k_acc, (n_chains,), e_dtype)
    # a non-finite proposal is rejected outright: the guard value alone
    # would still be accepted from a state whose own energy exceeds it
    accept = finite & (jnp.log(u) < jnp.minimum(jnp.asarray(0.0, e_dtype),
                                                log_alpha))

    new_state = state._replace(
        position=jnp.where(accept[:, None], q, state.position),
        log_prob=jnp.where(accept, lp, state.log_prob),
        grad_log_prob=jnp.where(accept[:, None], grad, state.grad_log_prob),
        accept_count=state.accept_count + accept.astype(jnp.int32),
        divergence_count=state.divergence_count + divergent.astype(jnp.int32),
    )
    return key, new_state, (accept, q, lp, delta_h)


@partial(jit, static_argnames=("log_prob_fn", "num_steps", "num_samples",
                               "burn_in", "friction_schedule", "track_proposals",
                               "value_and_grad_fn", "collect_chains", "backend"))
def grahmc_run(
    key,
    log_prob_fn,
    init_position,
    step_size,
    num_steps: int,
    gamma,
    steepness,
    num_samples: int,
    burn_in: int = 0,
    inv_mass_matrix: Optional[Array] = None,
    friction_schedule: Optional[Callable] = None,
    track_proposals: bool = False,
    value_and_grad_fn: Optional[Callable] = None,
    collect_chains: Optional[int] = None,
    backend: str = "auto",
) -> RunResult:
    """Run GRAHMC chains. friction_schedule defaults to the constant (RAHMC)
    schedule. With track_proposals, info carries pre/proposal positions,
    log-probs and delta_H for ESJD computation. backend: 'auto', 'xla',
    'pallas' or 'interpret' (ops/padded_targets.resolve_backend)."""
    if friction_schedule is None:
        friction_schedule = constant_schedule
    elif friction_schedule is NO_FRICTION:
        friction_schedule = None  # integrate_trajectory emits no friction ops

    state = grahmc_init(init_position, log_prob_fn, value_and_grad_fn)
    n_dim = state.position.shape[1]
    if inv_mass_matrix is None:
        inv_mass_matrix = jnp.ones(n_dim, dtype=state.position.dtype)
    inv_mass_matrix = jnp.asarray(inv_mass_matrix, state.position.dtype)

    vag = make_value_and_grad(log_prob_fn, value_and_grad_fn)
    steep = steepness if steepness is not None else 1.0

    backend = resolve_backend(backend, value_and_grad_fn)
    if backend != "xla":
        if jnp.ndim(inv_mass_matrix) == 2:
            # factor the dense metric ONCE for the whole run
            inv_mass_matrix = prepare_dense_metric(inv_mass_matrix, n_dim)
        fused = make_fused_grahmc_step(
            log_prob_fn, value_and_grad_fn, num_steps, friction_schedule,
            backend=backend)

        def step(k, s):
            return fused(k, s, step_size, gamma, steep, inv_mass_matrix)
    else:
        def step(k, s):
            return grahmc_step(k, s, vag, step_size, num_steps, gamma, steep,
                               inv_mass_matrix, friction_schedule)

    if track_proposals:
        def extras_fn(s_prev, s, step_extras):
            accept, q, lp, dh = step_extras
            return (s_prev.position, s_prev.log_prob, q, lp, dh)
        state, samples, log_probs, extras = run_sampler(
            step, key, state, num_samples, burn_in, collect_chains, extras_fn)
        pre_q, pre_lp, prop_q, prop_lp, delta_h = extras
        extra_info = {
            "pre_positions": pre_q,
            "pre_log_probs": pre_lp,
            "proposal_positions": prop_q,
            "proposal_log_probs": prop_lp,
            "delta_H": delta_h,
        }
        return finalize_run(state, samples, log_probs, num_samples, extra_info)

    state, samples, log_probs, _ = run_sampler(
        step, key, state, num_samples, burn_in, collect_chains)
    return finalize_run(state, samples, log_probs, num_samples)


# Reference-style aliases (reference exports rahmc_*: GRAHMC.py:127,264,352)
rahmc_init = grahmc_init
rahmc_step = grahmc_step
rahmc_run = grahmc_run
