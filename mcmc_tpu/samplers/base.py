"""Shared sampler infrastructure: chain state, target adapters, run harness.

Framework ABI (same as the reference's, SURVEY.md §1):
- positions are always (n_chains, n_dim); 1-D input is auto-batched,
- sample histories are (num_samples, n_chains, n_dim), log-probs
  (num_samples, n_chains), accept_rate (n_chains,) float32,
- log-probs/Hamiltonians in the energy dtype (float64 under x64, float32 on
  the accelerator path), positions/gradients in the position dtype.

Details:
- one ChainState NamedTuple for all samplers (grad field unused by RWMH),
  with a divergence counter the reference lacks (its divergence_rate is a
  hard-coded 0.0 placeholder, reference run_benchmarks.py:706-710),
- targets' batched analytic value-and-grad is used when available, removing
  vmap(jax.value_and_grad) from the hot loop,
- the run harness supports collecting only a chain prefix (``collect_chains``)
  so 10^5-chain runs don't materialize a (S, 10^5, D) history in device
  memory.
"""

from typing import Callable, NamedTuple, Optional, Tuple, Any, Dict

import jax
import jax.numpy as jnp
from jax import lax, vmap

from mcmc_tpu import precision

Array = jnp.ndarray
LogProbFn = Callable[[Array], Array]


class ChainState(NamedTuple):
    """State shared by every sampler.

    position:        (n_chains, n_dim)  position dtype
    log_prob:        (n_chains,)        energy dtype
    grad_log_prob:   (n_chains, n_dim)  position dtype (zeros for RWMH)
    accept_count:    (n_chains,)        int32
    divergence_count:(n_chains,)        int32  — |dH| > 1000 transitions
    """
    position: Array
    log_prob: Array
    grad_log_prob: Array
    accept_count: Array
    divergence_count: Array


class RunResult(NamedTuple):
    """Uniform sampler-run output.

    samples:    (num_samples, n_collect, n_dim)
    log_probs:  (num_samples, n_collect)
    accept_rate:(n_chains,) float32
    final_state: ChainState
    info:       dict of extras (divergence_rate, tree_depths, proposals, ...)
    """
    samples: Array
    log_probs: Array
    accept_rate: Array
    final_state: ChainState
    info: Dict[str, Any]


def ensure_batched(x: Array) -> Array:
    """(n_dim,) -> (1, n_dim); (n_chains, n_dim) unchanged."""
    x = jnp.asarray(x)
    if x.ndim == 1:
        return x[None, :]
    if x.ndim == 2:
        return x
    raise ValueError("Input must have shape (n_dim,) or (n_chains, n_dim).")


def make_value_and_grad(log_prob_fn: LogProbFn,
                        value_and_grad_fn: Optional[Callable] = None) -> Callable:
    """Batched (C, D) -> (lp (C,), grad (C, D)) target adapter.

    Prefers the target's analytic batched gradient; falls back to
    vmap(jax.value_and_grad) for black-box log-probs.
    """
    if value_and_grad_fn is not None:
        return value_and_grad_fn
    return vmap(jax.value_and_grad(log_prob_fn))


def make_batched_log_prob(log_prob_fn: LogProbFn) -> Callable:
    """Batched (C, D) -> (C,) adapter. Targets here are natively batched, so
    call directly; shape-polymorphic fallback via vmap is unnecessary because
    the framework ABI always passes (C, D)."""
    return log_prob_fn


def init_chain_state(init_position: Array, log_prob_fn: LogProbFn,
                     value_and_grad_fn: Optional[Callable] = None,
                     needs_grad: bool = True) -> ChainState:
    """Evaluate the target at the initial positions and build ChainState."""
    pos = ensure_batched(init_position)
    n_chains = pos.shape[0]
    e_dtype = precision.energy_dtype()
    if needs_grad:
        vag = make_value_and_grad(log_prob_fn, value_and_grad_fn)
        lp, grad = vag(pos)
        grad = grad.astype(pos.dtype)
    else:
        lp = log_prob_fn(pos)
        grad = jnp.zeros_like(pos)
    return ChainState(
        position=pos,
        log_prob=lp.astype(e_dtype),
        grad_log_prob=grad,
        accept_count=jnp.zeros(n_chains, dtype=jnp.int32),
        divergence_count=jnp.zeros(n_chains, dtype=jnp.int32),
    )


def reset_counters(state: ChainState) -> ChainState:
    return state._replace(
        accept_count=jnp.zeros_like(state.accept_count),
        divergence_count=jnp.zeros_like(state.divergence_count),
    )


def metropolis_accept(key, state: ChainState, proposal_pos, proposal_lp,
                      proposal_grad, log_alpha) -> Tuple[ChainState, Array]:
    """Shared MH acceptance: log u < min(0, log_alpha); where-select fields."""
    e_dtype = state.log_prob.dtype
    u = precision.accept_uniform(key, log_alpha.shape, e_dtype)
    accept = jnp.log(u) < jnp.minimum(jnp.asarray(0.0, e_dtype), log_alpha)
    new_state = state._replace(
        position=jnp.where(accept[:, None], proposal_pos, state.position),
        log_prob=jnp.where(accept, proposal_lp, state.log_prob),
        grad_log_prob=jnp.where(accept[:, None], proposal_grad, state.grad_log_prob),
        accept_count=state.accept_count + accept.astype(jnp.int32),
    )
    return new_state, accept


def run_sampler(
    step_fn: Callable,
    key: Array,
    state: ChainState,
    num_samples: int,
    burn_in: int = 0,
    collect_chains: Optional[int] = None,
    extras_fn: Optional[Callable] = None,
) -> Tuple[ChainState, Array, Array, Any]:
    """Generic burn-in + sampling harness.

    step_fn: (key, state) -> (key, state, step_extras)
    extras_fn: optional (prev_state, new_state, step_extras) -> pytree
        collected per step (prev_state enables ESJD-style pre/post tracking).
    collect_chains: store history only for the first k chains (None = all).

    Returns (final_state, samples, log_probs, stacked_extras).
    """
    n_collect = state.position.shape[0] if collect_chains is None else collect_chains

    if burn_in > 0:
        def burn_body(carry, _):
            k, s = carry
            k, s, _ = step_fn(k, s)
            return (k, s), None
        (key, state), _ = lax.scan(burn_body, (key, state), length=burn_in)
        state = reset_counters(state)

    def sample_body(carry, _):
        k, s_prev = carry
        k, s, step_extras = step_fn(k, s_prev)
        out = (s.position[:n_collect], s.log_prob[:n_collect])
        if extras_fn is not None:
            out = out + (extras_fn(s_prev, s, step_extras),)
        return (k, s), out

    (key, state), collected = lax.scan(sample_body, (key, state), length=num_samples)
    samples, log_probs = collected[0], collected[1]
    extras = collected[2] if extras_fn is not None else None
    return state, samples, log_probs, extras


def finalize_run(state: ChainState, samples, log_probs, num_samples: int,
                 extra_info: Optional[Dict] = None) -> RunResult:
    """Build the uniform RunResult with accept/divergence rates."""
    accept_rate = state.accept_count.astype(jnp.float32) / num_samples
    n_chains = state.position.shape[0]
    info = {
        "divergence_count": state.divergence_count,
        "total_divergences": jnp.sum(state.divergence_count),
        "divergence_rate": jnp.sum(state.divergence_count).astype(jnp.float32)
                           / (num_samples * n_chains),
    }
    if extra_info:
        info.update(extra_info)
    return RunResult(samples, log_probs, accept_rate, state, info)
