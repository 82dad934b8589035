"""No-U-Turn Sampler with iterative tree doubling (JIT-compatible).

Behavioral parity with reference samplers/NUTS.py — the reference's specific
simplifications are preserved deliberately, because they shape the sampled
posterior (SURVEY.md §3.3):

- iterative doubling via lax.while_loop, random +/-1 direction per subtree,
- subtree validity checked only at the subtree ENDPOINT; a valid endpoint
  counts the whole 2^depth subtree as valid states (reference NUTS.py:319-336),
- acceptance statistic: alpha = exp(min(0, h0 - h)) accumulated over ALL
  integration steps, Stan-style (reference NUTS.py:161-181),
- slice variable log u = log U(0,1) - h0; divergence when h - h0 > delta_max
  (default 1000); NaN mean-accept falls back to 0.65,
- U-turn when (q_right - q_left) . p_left < 0 or . p_right < 0,
- each chain gets its own key; chains vmapped.

Differences: endpoint updates are jnp.where selects instead of
lax.cond chains (cheaper under vmap), targets' batched analytic gradients are
used directly, and per-step divergences are counted into the chain state.
"""

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax, random, vmap

from mcmc_tpu import precision
from mcmc_tpu.samplers.trajectory import sample_momentum, velocity
from mcmc_tpu.samplers.base import (
    ChainState, RunResult, init_chain_state, run_sampler, finalize_run,
)

Array = jnp.ndarray


class _Tree(NamedTuple):
    """Trajectory endpoints + running proposal for one chain."""
    q_left: Array
    p_left: Array
    grad_left: Array
    q_right: Array
    p_right: Array
    grad_right: Array
    q_prop: Array
    lp_prop: Array
    grad_prop: Array
    n_valid: Array        # int32
    sum_alpha: Array      # energy dtype
    n_steps: Array        # int32


def _energy(lp, p, inv_mass):
    e_dtype = precision.energy_dtype()
    kin = 0.5 * jnp.sum(p * velocity(p, inv_mass))
    return -jnp.asarray(lp, e_dtype) + jnp.asarray(kin, e_dtype)


def _single_leapfrog(q, p, grad, signed_eps, value_and_grad, inv_mass):
    pos_dtype = q.dtype
    eps = jnp.asarray(signed_eps, pos_dtype)
    p = p + 0.5 * eps * grad
    q = q + eps * velocity(p, inv_mass)
    lp, grad = value_and_grad(q)
    grad = grad.astype(pos_dtype)
    p = p + 0.5 * eps * grad
    return q, p, jnp.asarray(lp, precision.energy_dtype()), grad


def _integrate_subtree(q, p, grad, direction, eps, num_steps, value_and_grad,
                       h0, inv_mass):
    """2^depth leapfrog steps in one direction, accumulating sum-alpha.

    Returns (q, p, lp, grad, sum_alpha). num_steps may be traced.
    """
    signed_eps = direction * eps
    e_dtype = h0.dtype
    lp0 = jnp.asarray(0.0, e_dtype)  # overwritten at the first step

    def body(i, carry):
        q, p, lp, grad, s_alpha = carry
        q, p, lp, grad = _single_leapfrog(q, p, grad, signed_eps,
                                          value_and_grad, inv_mass)
        h = _energy(lp, p, inv_mass)
        s_alpha = s_alpha + jnp.exp(jnp.minimum(jnp.asarray(0.0, e_dtype), h0 - h))
        return (q, p, lp, grad, s_alpha)

    return lax.fori_loop(0, num_steps, body,
                         (q, p, lp0, grad, jnp.asarray(0.0, e_dtype)))


def _u_turn(q_left, q_right, p_left, p_right, inv_mass):
    """U-turn test at the trajectory endpoints: the reference's raw-momentum
    criterion (q_r - q_l).p < 0 at either end (reference NUTS.py:191-198),
    for BOTH metrics.

    The raw dot is the correct dense generalization, not an approximation:
    with distance measured in the M-norm, d/dt ||q_r - q_l||^2_M =
    dq^T M (M^{-1} p) = dq.p, and under the whitening x = Az
    (A = chol(Sigma), inv_mass = Sigma) it transforms to the textbook
    criterion exactly: dz.p_z = (A^{-1}dq).(A^T p) = dq.p. The
    velocity-space variant dq.(M^{-1}p) measures EUCLIDEAN distance in the
    skewed coordinates instead; combined with the endpoint-only tree scheme
    it terminates irreversibly on metric ridges and was measured to clip
    the rho=0.9 compound-symmetry ridge eigenvalue by ~6% (classic) and
    ~24% (persistent machine) with the oracle metric."""
    dq = q_right - q_left
    return (jnp.dot(dq, p_left) < 0) | (jnp.dot(dq, p_right) < 0)


def _nuts_chain_step(key, q, lp, grad, value_and_grad, step_size,
                     max_tree_depth: int, delta_max, inv_mass):
    """One NUTS transition for a single chain.

    Returns (q', lp', grad', tree_depth, mean_accept_prob, diverged).
    """
    e_dtype = precision.energy_dtype()
    pos_dtype = q.dtype

    key, k_mom, k_slice = random.split(key, 3)
    p0 = sample_momentum(k_mom, q.shape, inv_mass, pos_dtype)
    h0 = _energy(lp, p0, inv_mass)
    log_u = jnp.log(precision.accept_uniform(k_slice, (), e_dtype)) - h0

    tree = _Tree(
        q_left=q, p_left=p0, grad_left=grad,
        q_right=q, p_right=p0, grad_right=grad,
        q_prop=q, lp_prop=lp, grad_prop=grad,
        n_valid=jnp.asarray(1, jnp.int32),
        sum_alpha=jnp.asarray(0.0, e_dtype),
        n_steps=jnp.asarray(0, jnp.int32),
    )

    def cond_fn(carry):
        depth, tree, diverged, _ = carry
        return ((depth < max_tree_depth)
                & ~_u_turn(tree.q_left, tree.q_right, tree.p_left,
                           tree.p_right, inv_mass)
                & ~diverged)

    def body_fn(carry):
        depth, tree, diverged, key = carry
        key, k_dir, k_swap = random.split(key, 3)
        go_right = random.bernoulli(k_dir)
        direction = jnp.where(go_right, 1.0, -1.0).astype(pos_dtype)

        q_start = jnp.where(go_right, tree.q_right, tree.q_left)
        p_start = jnp.where(go_right, tree.p_right, tree.p_left)
        g_start = jnp.where(go_right, tree.grad_right, tree.grad_left)

        num_steps = jnp.asarray(2, jnp.int32) ** depth
        q_new, p_new, lp_new, g_new, sub_alpha = _integrate_subtree(
            q_start, p_start, g_start, direction, step_size, num_steps,
            value_and_grad, h0, inv_mass)

        h_new = _energy(lp_new, p_new, inv_mass)
        in_slice = log_u <= -h_new
        is_divergent = (h_new - h0) > delta_max
        is_valid = in_slice & ~is_divergent

        tree = tree._replace(
            q_left=jnp.where(go_right, tree.q_left, q_new),
            p_left=jnp.where(go_right, tree.p_left, p_new),
            grad_left=jnp.where(go_right, tree.grad_left, g_new),
            q_right=jnp.where(go_right, q_new, tree.q_right),
            p_right=jnp.where(go_right, p_new, tree.p_right),
            grad_right=jnp.where(go_right, g_new, tree.grad_right),
        )

        # Endpoint-validity scheme: a valid endpoint counts the whole subtree.
        n_valid_new = jnp.where(is_valid, num_steps, 0)
        total_valid = tree.n_valid + n_valid_new
        swap_prob = jnp.where(
            is_valid & (total_valid > 0),
            n_valid_new.astype(jnp.float32) / jnp.maximum(total_valid, 1).astype(jnp.float32),
            0.0,
        )
        take_new = random.uniform(k_swap) < swap_prob

        tree = tree._replace(
            q_prop=jnp.where(take_new, q_new, tree.q_prop),
            lp_prop=jnp.where(take_new, lp_new, tree.lp_prop),
            grad_prop=jnp.where(take_new, g_new, tree.grad_prop),
            n_valid=total_valid,
            sum_alpha=tree.sum_alpha + sub_alpha,
            n_steps=tree.n_steps + num_steps,
        )
        return (depth + 1, tree, diverged | is_divergent, key)

    depth0 = jnp.asarray(0, jnp.int32)
    final_depth, tree, diverged, _ = lax.while_loop(
        cond_fn, body_fn, (depth0, tree, jnp.asarray(False), key))

    mean_alpha = tree.sum_alpha / jnp.maximum(tree.n_steps, 1)
    mean_alpha = jnp.where(jnp.isfinite(mean_alpha), mean_alpha,
                           jnp.asarray(0.65, e_dtype))

    return tree.q_prop, tree.lp_prop, tree.grad_prop, final_depth, mean_alpha, diverged


def nuts_init(init_position, log_prob_fn, value_and_grad_fn=None) -> ChainState:
    return init_chain_state(init_position, log_prob_fn, value_and_grad_fn,
                            needs_grad=True)


def nuts_step(key, state: ChainState, value_and_grad_single, step_size,
              inv_mass_matrix, max_tree_depth: int = 10, delta_max=1000.0):
    """One NUTS step for all chains (each with its own key).

    Returns (key, new_state, (depths, mean_accept_probs)).
    """
    n_chains = state.position.shape[0]
    keys = random.split(key, n_chains + 1)

    step_one = partial(_nuts_chain_step,
                       value_and_grad=value_and_grad_single,
                       step_size=step_size,
                       max_tree_depth=max_tree_depth,
                       delta_max=delta_max,
                       inv_mass=inv_mass_matrix)

    q, lp, grad, depths, mean_alpha, diverged = vmap(step_one)(
        keys[1:], state.position, state.log_prob, state.grad_log_prob)

    new_state = state._replace(
        position=q,
        log_prob=lp,
        grad_log_prob=grad,
        accept_count=state.accept_count + 1,  # NUTS always moves via slice sampling
        divergence_count=state.divergence_count + diverged.astype(jnp.int32),
    )
    return keys[0], new_state, (depths, mean_alpha)


@partial(jax.jit, static_argnames=("log_prob_fn", "num_samples", "burn_in",
                                   "max_tree_depth", "value_and_grad_fn",
                                   "collect_chains"))
def nuts_run(
    key,
    log_prob_fn,
    init_position,
    step_size,
    num_samples: int,
    burn_in: int = 0,
    inv_mass_matrix: Optional[Array] = None,
    max_tree_depth: int = 10,
    delta_max=1000.0,
    value_and_grad_fn: Optional[Callable] = None,
    collect_chains: Optional[int] = None,
) -> RunResult:
    """Run NUTS chains. info carries tree_depths and mean_accept_probs
    (num_samples, n_chains) plus divergence stats."""
    state = nuts_init(init_position, log_prob_fn, value_and_grad_fn)
    n_dim = state.position.shape[1]
    if inv_mass_matrix is None:
        inv_mass_matrix = jnp.ones(n_dim, dtype=state.position.dtype)
    inv_mass_matrix = jnp.asarray(inv_mass_matrix, state.position.dtype)

    # Single-chain (D,) -> (lp, grad) adapter: analytic targets are
    # shape-polymorphic; black-box log-probs use jax.value_and_grad.
    if value_and_grad_fn is not None:
        vag_single = value_and_grad_fn
    else:
        vag_single = jax.value_and_grad(log_prob_fn)

    def step(k, s):
        return nuts_step(k, s, vag_single, step_size, inv_mass_matrix,
                         max_tree_depth, delta_max)

    def extras_fn(s_prev, s, step_extras):
        return step_extras  # (depths, mean_alpha)

    state, samples, log_probs, extras = run_sampler(
        step, key, state, num_samples, burn_in, collect_chains, extras_fn)
    depths, mean_alpha = extras
    extra_info = {"tree_depths": depths, "mean_accept_probs": mean_alpha}
    return finalize_run(state, samples, log_probs, num_samples, extra_info)
