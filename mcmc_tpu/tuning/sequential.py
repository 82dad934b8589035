"""Sequential GRAHMC friction tuning: DA step-size phase + ESJD gamma search.

The reference's production GRAHMC tuner (``tuning/sequential_tune_grahmc.py``)
is missing from its snapshot; this implements the documented contract
(reference adaptation.py:282-300, dual_averaging.py:683-708, README "GRAHMC
Sequential Tuning"):

1. Phase 1 — tune step size by dual averaging at a conservative gamma = 0.5
   (step size and friction have opposite relationships with acceptance, so
   they cannot be tuned jointly from the acceptance signal alone).
2. Phase 2 — grid-search gamma over coarse values [0.01, 0.1, 0.5, 1.0, 2.0,
   5.0]: for each gamma, RE-TUNE the step size by DA at that gamma
   (``max_iter_step`` warmup iterations per gamma — the contract's
   "(re-tuned)" step size, reference adaptation.py:295,332), then measure
   ESJD from ``gamma_samples_per_eval`` tracked proposals:
       ESJD = E[ alpha * ||q_proposal - q_pre||^2 ],  alpha = min(1, e^{-dH}).
   The winning gamma's step size is returned.
3. Steepness stays at the schedule-specific default (0.5 tanh / 2.0 sigmoid).

Each per-gamma evaluation (DA re-tune + ESJD scan) is one compiled device
function reused across the grid (gamma is a traced scalar).
"""

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax, random

from mcmc_tpu.samplers.base import make_value_and_grad, init_chain_state
from mcmc_tpu.samplers.grahmc import grahmc_step, get_friction_schedule, default_steepness
from mcmc_tpu.tuning.dual_averaging import (
    da_init, da_update, da_step_size, da_final_step_size,
)

DEFAULT_GAMMA_GRID = (0.01, 0.1, 0.5, 1.0, 2.0, 5.0)
CONSERVATIVE_GAMMA = 0.5


def sequential_tune_grahmc(
    key,
    log_prob_fn,
    grad_log_prob_fn,              # API parity; analytic grads via value_and_grad_fn
    init_position,
    num_steps: int,
    schedule_type: str = "constant",
    target_accept: float = 0.65,
    max_iter_step: int = 1000,
    inv_mass_matrix=None,
    init_step_size: Optional[float] = None,
    gamma_coarse_values=None,
    gamma_samples_per_eval: int = 150,
    value_and_grad_fn=None,
    steepness: Optional[float] = None,
    da_batch: int = 25,
    verbose: bool = False,
    backend: str = "xla",
    mesh=None,
) -> Tuple[float, float, float, Dict]:
    """Returns (step_size, gamma, steepness, history).

    mesh: run every DA/ESJD probe shard_mapped over the chain mesh — the
    fused kernel executes per device on its local shard and the DA/ESJD
    feedback uses pmean'd global statistics, so the tuned values are
    identical on every device (completes the mesh story: warmup windows,
    sampling AND friction tuning all run the fused paths multi-chip)."""
    if gamma_coarse_values is None:
        gamma_coarse_values = DEFAULT_GAMMA_GRID
    if steepness is None:
        steepness = default_steepness(schedule_type)

    if mesh is not None:
        from mcmc_tpu.parallel import CHAIN_AXIS
        axis = CHAIN_AXIS
    else:
        axis = None

    def _gmean(x):
        """Global mean over all chains (pmean over the mesh axis when
        sharded; shards are equal-sized so the mean of means is exact)."""
        m = jnp.mean(x)
        return lax.pmean(m, axis) if axis is not None else m

    schedule_fn = get_friction_schedule(schedule_type)
    vag = make_value_and_grad(log_prob_fn, value_and_grad_fn)

    if backend != "xla":
        from mcmc_tpu.ops.fused_trajectory import make_fused_grahmc_step
        fused = make_fused_grahmc_step(log_prob_fn, value_and_grad_fn,
                                       num_steps, schedule_fn,
                                       backend=backend)

        def transition(k, s, step_size, gamma):
            return fused(k, s, step_size, gamma, steepness, inv_mass_matrix)
    else:
        def transition(k, s, step_size, gamma):
            return grahmc_step(k, s, vag, step_size, num_steps, gamma,
                               jnp.asarray(steepness), inv_mass_matrix,
                               schedule_fn)

    state = init_chain_state(init_position, log_prob_fn, value_and_grad_fn,
                             needs_grad=True)
    n_dim = state.position.shape[1]
    if inv_mass_matrix is None:
        inv_mass_matrix = jnp.ones(n_dim, state.position.dtype)
    inv_mass_matrix = jnp.asarray(inv_mass_matrix, state.position.dtype)

    if init_step_size is None:
        init_step_size = 0.5 / float(jnp.sqrt(n_dim))

    # One compiled function serves Phase 1 and every Phase-2 gamma: DA-tune
    # the step size at the given gamma, then measure ESJD at the tuned step.
    n_da_updates = max(1, max_iter_step // da_batch)

    def _tune_and_measure_body(key, chain_state, gamma, start_step):
        if axis is not None:
            # distinct per-device stream; DA state stays replicated because
            # its feedback statistics are pmean'd globals
            key = random.fold_in(key, lax.axis_index(axis))
        da = da_init(start_step)

        def da_iter(carry, _):
            key, cs, da = carry
            step_size = da_step_size(da)

            def step_body(inner, _):
                k, s = inner
                k, s, (accept, *_r) = transition(k, s, step_size, gamma)
                return (k, s), accept

            (key, cs), accepts = lax.scan(step_body, (key, cs), length=da_batch)
            stat = _gmean(accepts)
            da = da_update(da, stat, target_accept)
            return (key, cs, da), stat

        (key, chain_state, da), accepts = lax.scan(
            da_iter, (key, chain_state, da), length=n_da_updates)
        tuned_step = da_final_step_size(da)

        def esjd_body(carry, _):
            k, s = carry
            pre_q = s.position
            k, s, (accept, prop_q, prop_lp, delta_h) = transition(
                k, s, tuned_step, gamma)
            alpha = jnp.exp(jnp.minimum(0.0, -delta_h))
            jump_sq = jnp.sum((prop_q - pre_q) ** 2, axis=-1)
            return (k, s), (alpha * jump_sq, accept)

        (key, chain_state), (esjd_steps, esjd_accepts) = lax.scan(
            esjd_body, (key, chain_state), length=gamma_samples_per_eval)
        return (chain_state, tuned_step, _gmean(esjd_steps),
                _gmean(esjd_accepts), accepts)

    if mesh is None:
        tune_and_measure = jax.jit(_tune_and_measure_body)
    else:
        from jax.sharding import PartitionSpec as P
        from mcmc_tpu.parallel import shard_map_fn
        from mcmc_tpu.tuning.adaptation import _state_pspec

        @jax.jit
        def tune_and_measure(key, chain_state, gamma, start_step):
            specs = _state_pspec(chain_state, "leading")
            return shard_map_fn(
                _tune_and_measure_body, mesh,
                in_specs=(P(), specs, P(), P()),
                out_specs=(specs, P(), P(), P(), P()))(
                    key, chain_state, gamma, start_step)

    # Phase 1: conservative-gamma step tune (gives each gamma's DA warm start)
    key, p1_key = random.split(key)
    state, base_step, _, _, da_accepts = tune_and_measure(
        p1_key, state, jnp.asarray(CONSERVATIVE_GAMMA, state.position.dtype),
        jnp.asarray(init_step_size))
    if verbose:
        print(f"    [sequential] phase 1: step={float(base_step):.5f} "
              f"(accept {float(da_accepts[-1]):.3f} at gamma={CONSERVATIVE_GAMMA})")

    # Phase 2: per-gamma step re-tune + ESJD measurement
    history = {"gamma_grid": list(gamma_coarse_values), "esjd": [],
               "accept": [], "per_gamma_step": [],
               "da_accept_history": [float(a) for a in da_accepts]}

    best = None  # (esjd, gamma, step)
    for i, g in enumerate(gamma_coarse_values):
        _, step_g, esjd, acc, _ = tune_and_measure(
            random.fold_in(key, i), state,
            jnp.asarray(g, state.position.dtype), base_step)
        esjd_f, acc_f, step_f = float(esjd), float(acc), float(step_g)
        history["esjd"].append(esjd_f)
        history["accept"].append(acc_f)
        history["per_gamma_step"].append(step_f)
        if verbose:
            print(f"    [sequential] gamma={g}: step={step_f:.4f} "
                  f"ESJD={esjd_f:.4f} accept={acc_f:.3f}")
        if best is None or esjd_f > best[0]:
            best = (esjd_f, g, step_f)

    _, best_gamma, best_step = best
    history["selected_gamma"] = best_gamma
    history["step_size"] = best_step
    return float(best_step), float(best_gamma), float(steepness), history
