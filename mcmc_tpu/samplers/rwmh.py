"""Random-Walk Metropolis-Hastings (behavioral parity: reference samplers/RWMH.py).

Gaussian proposal x' = x + scale * eps, MH test log u < min(0, dlogp), burn-in
with counter reset. One fused (n_chains, n_dim) step under lax.scan; XLA fuses
the threefry draws into the update, so a hand-written kernel would only win
with a counter-based generator inside it (ROADMAP).
"""

from functools import partial
from typing import Optional

import jax.numpy as jnp
from jax import jit, random

from mcmc_tpu import precision
from mcmc_tpu.samplers.base import (
    ChainState, RunResult, ensure_batched, init_chain_state,
    run_sampler, finalize_run,
)


def rwmh_init(init_position, log_prob_fn) -> ChainState:
    return init_chain_state(init_position, log_prob_fn, needs_grad=False)


def rwmh_step(key, state: ChainState, log_prob_fn, scale):
    """One RWMH step for all chains; returns (key, new_state, accept)."""
    n_chains, n_dim = state.position.shape
    pos_dtype = state.position.dtype
    e_dtype = state.log_prob.dtype

    key, k_noise, k_accept = random.split(key, 3)
    noise = random.normal(k_noise, (n_chains, n_dim), dtype=pos_dtype)
    proposal = state.position + jnp.asarray(scale, pos_dtype) * noise
    proposal_lp = log_prob_fn(proposal).astype(e_dtype)

    log_ratio = proposal_lp - state.log_prob
    u = precision.accept_uniform(k_accept, (n_chains,), e_dtype)
    accept = jnp.log(u) < jnp.minimum(jnp.asarray(0.0, e_dtype), log_ratio)

    new_state = state._replace(
        position=jnp.where(accept[:, None], proposal, state.position),
        log_prob=jnp.where(accept, proposal_lp, state.log_prob),
        accept_count=state.accept_count + accept.astype(jnp.int32),
    )
    return key, new_state, accept


@partial(jit, static_argnames=("log_prob_fn", "num_samples", "burn_in",
                               "collect_chains"))
def rwmh_run(
    key,
    log_prob_fn,
    init_position,
    num_samples: int,
    scale,
    burn_in: int = 0,
    collect_chains: Optional[int] = None,
) -> RunResult:
    """Run RWMH chains. Returns RunResult (see samplers.base)."""
    state = rwmh_init(init_position, log_prob_fn)

    def step(k, s):
        return rwmh_step(k, s, log_prob_fn, scale)

    state, samples, log_probs, _ = run_sampler(
        step, key, state, num_samples, burn_in, collect_chains)
    return finalize_run(state, samples, log_probs, num_samples)


