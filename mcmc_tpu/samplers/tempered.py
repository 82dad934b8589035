"""Parallel tempering (replica exchange) over the HMC/GRAHMC transition.

Beyond-reference capability: the reference has no remedy for multimodal
targets — its own gaussian_mixture benchmark relies on an init_sampler that
seeds chains in both modes (reference benchmarks/targets.py:456-465), and a
chain started in one mode essentially never crosses at sep=5 (the documented
all-target-soak failure). Replica exchange is the standard fix: K tempered
replicas sample pi^{beta_k} (flat enough to cross at small beta), and
adjacent replicas exchange configurations with the Metropolis probability

    A = min(1, exp((beta_i - beta_j) * (logp(x_j) - logp(x_i))))

which preserves the product measure prod_k pi^{beta_k}; the beta=1 replica
is then an exact sampler of pi with mode-hopping supplied by the ladder.

Design: the K x C replica-chain grid is ONE flattened (K*C, D)
batch through the shared conformal-leapfrog transition (samplers/grahmc.py
grahmc_step) — per-replica tempering enters as a (K*C,) row scaling the
batched value-and-grad (tempered grad = beta * grad) and a per-chain step
size row (eps_k = eps / sqrt(beta_k) by default: the tempered target's
curvature scales with beta), both pure broadcasts in the leapfrog. Swap
moves are where-selects between adjacent rows of the (K, C, ...) view with
alternating even/odd pairing per iteration — no gather/scatter, no host
control flow, everything inside one jitted lax.scan. Chains (the C axis)
remain embarrassingly parallel: a future mesh sharding over C keeps every
swap device-local because exchanges act along K only.

Energy bookkeeping: ChainState carries the TEMPERED log-prob/grad (what the
transition needs); swaps convert through the exact per-replica beta rows.
The emitted samples/log-probs are the beta=1 replica's, untempered.
"""

from functools import partial
from typing import Callable, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import jit, lax, random

from mcmc_tpu import precision
from mcmc_tpu.samplers.base import (ChainState, RunResult, init_chain_state,
                                    reset_counters)
from mcmc_tpu.ops.fused_trajectory import make_fused_grahmc_step
from mcmc_tpu.ops.padded_targets import resolve_backend
from mcmc_tpu.samplers.grahmc import grahmc_step

Array = jnp.ndarray


def geometric_ladder(n_temps: int, beta_min: float = 0.05) -> jnp.ndarray:
    """Geometrically spaced inverse temperatures 1 = beta_0 > ... > beta_min.

    Geometric spacing equalizes the per-pair log-density overlap for
    targets whose energy scales roughly linearly in beta (the classic
    choice; swap acceptance then stays ~flat along the ladder)."""
    if n_temps < 1:
        raise ValueError("n_temps must be >= 1")
    if n_temps == 1:
        return jnp.ones((1,), jnp.float32)
    if not 0.0 < beta_min < 1.0:
        raise ValueError("beta_min must be in (0, 1)")
    k = jnp.arange(n_temps, dtype=jnp.float32) / (n_temps - 1)
    return jnp.asarray(beta_min, jnp.float32) ** k


def _validate_betas(betas) -> None:
    """Host-side ladder sanity. A bad explicit ladder must error loudly:
    betas[0] != 1 silently emits draws of pi^beta_0 while labeling their
    log-probs untempered, and beta <= 0 NaNs the swap phase."""
    b = np.asarray(betas, np.float64)
    if b.ndim != 1 or b.size < 1:
        raise ValueError(f"betas must be a 1-D ladder, got shape {b.shape}")
    if not np.all(np.isfinite(b)) or np.any(b <= 0.0):
        raise ValueError(f"betas must be finite and strictly positive: {b}")
    if abs(b[0] - 1.0) > 1e-6:
        raise ValueError("betas[0] must be 1.0 (the cold, untempered rung "
                         f"whose draws are emitted), got {b[0]}")
    if b.size > 1 and np.any(np.diff(b) >= 0.0):
        raise ValueError(f"betas must be strictly descending: {b}")


def tempered_run(
    key,
    log_prob_fn,
    init_position,
    step_size,
    num_steps: int,
    num_samples: int,
    betas: Optional[Array] = None,
    n_temps: int = 6,
    beta_min: float = 0.05,
    burn_in: int = 0,
    swap_interval: int = 1,
    inv_mass_matrix: Optional[Array] = None,
    gamma=0.0,
    steepness=1.0,
    friction_schedule: Optional[Callable] = None,
    value_and_grad_fn: Optional[Callable] = None,
    collect_chains: Optional[int] = None,
    backend: str = "auto",
    init_replica_position: Optional[Array] = None,
) -> RunResult:
    """Replica-exchange HMC/GRAHMC — see `_tempered_run_jit` for the full
    contract (this thin wrapper only validates a concrete explicit ladder
    before entering the jitted core, where betas is a tracer)."""
    if betas is not None and not isinstance(betas, jax.core.Tracer):
        _validate_betas(betas)
    return _tempered_run_jit(
        key, log_prob_fn, init_position, step_size, num_steps=num_steps,
        num_samples=num_samples, betas=betas, n_temps=n_temps,
        beta_min=beta_min, burn_in=burn_in, swap_interval=swap_interval,
        inv_mass_matrix=inv_mass_matrix, gamma=gamma, steepness=steepness,
        friction_schedule=friction_schedule,
        value_and_grad_fn=value_and_grad_fn, collect_chains=collect_chains,
        backend=backend, init_replica_position=init_replica_position)


@partial(jit, static_argnames=(
    "log_prob_fn", "num_steps", "num_samples", "burn_in", "n_temps",
    "beta_min", "swap_interval", "friction_schedule", "value_and_grad_fn",
    "collect_chains", "backend"))
def _tempered_run_jit(
    key,
    log_prob_fn,
    init_position,
    step_size,
    num_steps: int,
    num_samples: int,
    betas: Optional[Array] = None,
    n_temps: int = 6,
    beta_min: float = 0.05,
    burn_in: int = 0,
    swap_interval: int = 1,
    inv_mass_matrix: Optional[Array] = None,
    gamma=0.0,
    steepness=1.0,
    friction_schedule: Optional[Callable] = None,
    value_and_grad_fn: Optional[Callable] = None,
    collect_chains: Optional[int] = None,
    backend: str = "auto",
    init_replica_position: Optional[Array] = None,
) -> RunResult:
    """Replica-exchange HMC/GRAHMC. Returns the beta=1 replica's RunResult.

    init_position: (C, D) — replicated across the K temperatures.
    step_size: scalar (auto-scaled per replica as eps / sqrt(beta_k)) or an
    explicit (K,) array of per-temperature step sizes.
    betas: explicit descending ladder with betas[0] == 1, or None for
    geometric_ladder(n_temps, beta_min).
    friction_schedule/gamma/steepness: optional GRAHMC friction (None =
    plain HMC), shared across replicas.
    swap_interval: transitions between exchange attempts (1 = every step;
    pairing alternates even/odd so a configuration can traverse the whole
    ladder in ~K swap phases).

    Output contract matches the other samplers: samples (num_samples, C, D)
    and UNtempered log_probs (num_samples, C) from the cold replica,
    accept_rate/divergences from the cold replica's transitions. info adds
    `swap_accept_rate` / `swap_attempts` ((K-1,) per adjacent pair), `betas`,
    `replica_step_sizes`, and `replica_final_positions` ((K*C, D) — pass a
    run's final replica positions back in as `init_replica_position` to
    continue the ladder without re-equilibrating the hot rungs, e.g. the
    benchmark runner's convergence-checkpoint batches). Cited against the
    gaussian_mixture failure mode: reference benchmarks/targets.py:411-482
    (bimodal target + split-mode init_sampler workaround).

    backend: 'xla' (grahmc_step scan), 'pallas' (the fused trajectory
    kernel, ops/fused_trajectory.py — ONE compiled kernel shared by all K
    replicas, called per replica with its scalar (eps_k, beta_k); the beta
    enters the kernel as the static-gated lp_scale), 'interpret' (that
    kernel under the Pallas interpreter) or 'auto'
    (ops/padded_targets.resolve_backend).
    """
    backend = resolve_backend(backend, value_and_grad_fn)
    if betas is None:
        betas = geometric_ladder(n_temps, beta_min)
    betas = jnp.asarray(betas, jnp.float32)
    K = betas.shape[0]
    C, D = init_position.shape
    N = K * C
    if swap_interval < 1:
        raise ValueError("swap_interval must be >= 1")

    # flattened replica-major batch: row r = replica r // C, chain r % C
    beta_row = jnp.repeat(betas, C)                       # (N,)
    if init_replica_position is not None:
        pos0 = jnp.asarray(init_replica_position)         # (N, D) continuation
        if pos0.shape != (N, D):
            raise ValueError(f"init_replica_position must be ({N}, {D}), "
                             f"got {pos0.shape}")
    else:
        pos0 = jnp.tile(jnp.asarray(init_position), (K, 1))   # (N, D)

    if value_and_grad_fn is not None:
        base_vag = value_and_grad_fn
    else:
        base_vag = jax.vmap(jax.value_and_grad(log_prob_fn))

    e_dtype = precision.energy_dtype()

    def tempered_vag(q):
        lp, g = base_vag(q)
        return (beta_row.astype(lp.dtype) * lp,
                beta_row[:, None].astype(g.dtype) * g)

    state = init_chain_state(pos0, None, tempered_vag, needs_grad=True)

    # per-replica step sizes: hotter targets are flatter (curvature ~ beta),
    # so the stable step grows like 1/sqrt(beta) — unless given explicitly
    step_size = jnp.asarray(step_size, jnp.float32)
    if step_size.ndim == 0:
        replica_steps = step_size / jnp.sqrt(betas)       # (K,)
    else:
        if step_size.shape != (K,):
            raise ValueError(f"step_size must be scalar or shape ({K},), "
                             f"got {step_size.shape}")
        replica_steps = step_size
    eps_row = jnp.repeat(replica_steps, C)[:, None]       # (N, 1)

    if inv_mass_matrix is None:
        inv_mass_matrix = jnp.ones(D, state.position.dtype)
    inv_mass = jnp.asarray(inv_mass_matrix, state.position.dtype)

    pair_idx = jnp.arange(K)
    pair_cap = pair_idx < (K - 1)                         # row K-1 has no next

    def swap_phase(key, state, phase, swap_acc):
        """One exchange attempt over pairs (k, k+1) with k ≡ phase (mod 2).

        Works on the (K, C, ...) view; every neighbor access is a roll of
        the replica axis with wrapped rows masked off by pair activity."""
        key, ku = random.split(key)
        lp_t = state.log_prob.reshape(K, C)               # tempered
        lp_un = lp_t / betas[:, None].astype(lp_t.dtype)  # exact: lp_t = b*lp
        q = state.position.reshape(K, C, D)
        g_un = (state.grad_log_prob.reshape(K, C, D)
                / betas[:, None, None].astype(state.grad_log_prob.dtype))

        nxt = lambda a: jnp.roll(a, -1, axis=0)
        d_beta = (betas - jnp.roll(betas, -1)).astype(lp_un.dtype)  # b_k-b_{k+1}
        log_acc = d_beta[:, None] * (nxt(lp_un) - lp_un)  # (K, C)
        active = (pair_cap & ((pair_idx % 2) == phase))[:, None]
        u = precision.accept_uniform(ku, (K, C), lp_un.dtype)
        take_next = active & (jnp.log(u) < log_acc)       # row k adopts k+1
        take_prev = jnp.roll(take_next, 1, axis=0)        # row k+1 adopts k
        # roll wrap is harmless: row 0's take_prev comes from row K-1, which
        # is never an active pair low end (pair_cap)

        def mix(x, m2, m3):
            prv = jnp.roll(x, 1, axis=0)
            return jnp.where(m2, nxt(x), jnp.where(m3, prv, x))

        q_new = mix(q, take_next[..., None], take_prev[..., None])
        lp_new = mix(lp_un, take_next, take_prev)
        g_new = mix(g_un, take_next[..., None], take_prev[..., None])

        state = state._replace(
            position=q_new.reshape(N, D),
            log_prob=(betas[:, None].astype(lp_new.dtype)
                      * lp_new).reshape(N),
            grad_log_prob=(betas[:, None, None].astype(g_new.dtype)
                           * g_new).reshape(N, D),
        )
        # per-pair mean acceptance (masked rows contribute where active)
        swap_acc = (swap_acc[0] + jnp.where(active, take_next, False)
                    .sum(axis=1).astype(jnp.float32)[:K - 1],
                    swap_acc[1] + active[:, 0].astype(jnp.float32)[:K - 1] * C)
        return key, state, swap_acc

    if backend != "xla":
        fused_step = make_fused_grahmc_step(
            log_prob_fn, value_and_grad_fn, num_steps, friction_schedule,
            backend=backend)

        def replica_sweep(key, state):
            """One MH transition on every replica: K calls into the ONE
            compiled fused kernel (the call cache keys on shape, not the
            (eps_k, beta_k) scalars), state sliced replica-major."""
            keys = random.split(key, K + 1)
            parts = []
            for k in range(K):
                sl = slice(k * C, (k + 1) * C)
                sub = ChainState(
                    position=state.position[sl],
                    log_prob=state.log_prob[sl],
                    grad_log_prob=state.grad_log_prob[sl],
                    accept_count=state.accept_count[sl],
                    divergence_count=state.divergence_count[sl])
                _, sub, _extras = fused_step(
                    keys[k + 1], sub, replica_steps[k], gamma, steepness,
                    inv_mass, lp_scale=betas[k])
                parts.append(sub)
            state = ChainState(*(jnp.concatenate([getattr(p, f)
                                                  for p in parts])
                                 for f in ChainState._fields))
            return keys[0], state
    else:
        def replica_sweep(key, state):
            key, state, _extras = grahmc_step(
                key, state, tempered_vag, eps_row, num_steps,
                gamma=gamma, steepness=steepness, inv_mass_matrix=inv_mass,
                friction_schedule=friction_schedule)
            return key, state

    def transition(carry, it):
        key, state, swap_acc = carry
        key, state = replica_sweep(key, state)
        do_swap = (it % swap_interval) == (swap_interval - 1)
        phase = (it // swap_interval) % 2

        def do(args):
            key, state, swap_acc = args
            return swap_phase(key, state, phase, swap_acc)

        key, state, swap_acc = lax.cond(
            do_swap, do, lambda a: a, (key, state, swap_acc))
        return (key, state, swap_acc), None

    # (K-1,) per adjacent pair; shape (0,) at K=1 keeps the cond branches'
    # pytrees identical (a padded buffer would change shape under [:K-1])
    swap_acc0 = (jnp.zeros(K - 1, jnp.float32),
                 jnp.zeros(K - 1, jnp.float32))

    if burn_in > 0:
        (key, state, swap_acc0), _ = lax.scan(
            transition, (key, state, swap_acc0), jnp.arange(burn_in))
        state = reset_counters(state)
        swap_acc0 = (jnp.zeros_like(swap_acc0[0]),
                     jnp.zeros_like(swap_acc0[1]))

    n_collect = collect_chains or C

    def emit(carry, it):
        carry, _ = transition(carry, it + burn_in)
        _, state, _ = carry
        cold_q = state.position[:C][:n_collect]
        cold_lp = (state.log_prob[:C]
                   / betas[0].astype(state.log_prob.dtype))[:n_collect]
        return carry, (cold_q, cold_lp)

    (key, state, swap_acc), (samples, lps) = lax.scan(
        emit, (key, state, swap_acc0), jnp.arange(num_samples))

    cold = ChainState(
        position=state.position[:C],
        log_prob=state.log_prob[:C],
        grad_log_prob=state.grad_log_prob[:C],
        accept_count=state.accept_count[:C],
        divergence_count=state.divergence_count[:C])
    accept_rate = (cold.accept_count.astype(jnp.float32)
                   / max(num_samples, 1))
    total_div = jnp.sum(cold.divergence_count)
    swap_rate = swap_acc[0] / jnp.maximum(swap_acc[1], 1.0)
    info = {
        "divergence_count": cold.divergence_count,
        "total_divergences": total_div,
        "divergence_rate": total_div.astype(jnp.float32)
        / max(num_samples * C, 1),
        "final_positions": cold.position,
        # full-ladder continuation state (see init_replica_position)
        "replica_final_positions": state.position,
        "swap_accept_rate": swap_rate,
        # attempts per adjacent pair: 0 means "never tried" (a burst
        # shorter than one even/odd cycle), which a rate of 0 alone
        # cannot distinguish from "always rejected" — the ladder tuner
        # checks this (tuning/ladder.py)
        "swap_attempts": swap_acc[1],
        "betas": betas,
        "replica_step_sizes": replica_steps,
        "n_temps": jnp.asarray(K, jnp.int32),
        # all-replica transition acceptance, (K,) — ladder health at a glance
        "replica_accept_rate": (state.accept_count.reshape(K, C)
                                .astype(jnp.float32).mean(axis=1)
                                / max(num_samples, 1)),
    }
    return RunResult(samples, lps.astype(e_dtype), accept_rate, cold, info)
