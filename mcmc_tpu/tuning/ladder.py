"""Adaptive tempering-ladder tuning (stochastic approximation on spacings).

Beyond-reference capability (the reference has no tempering at all; the
rebuild's `samplers/tempered.py` added the ladder, this module tunes it).
A geometric ladder equalizes swap acceptance only when the energy scales
linearly in beta — on funnels, mixtures with unequal-width modes, or any
target whose effective dimension changes along the ladder, geometric
spacing leaves some adjacent pairs near-frozen (swap acceptance ~ 0, the
ladder splits in two) while others waste rungs at ~1.

The standard remedy (Miasojedow, Moulines & Vihola 2013, "An adaptive
parallel tempering algorithm") is Robbins-Monro on the LOG-SPACINGS of the
inverse temperatures, driving every adjacent pair's swap acceptance to the
optimal 0.234 (Atchade, Roberts & Rosenthal 2011 — same 0.234 as RWMH, and
the constant the reference already targets for RWMH step tuning,
reference tuning/dual_averaging.py:20):

    beta_0 = 1,  beta_{k+1} = beta_k * exp(-exp(rho_k))
    rho_k <- rho_k + eta_t * (A_k - 0.234)

Acceptance above target => the rungs are closer than they need to be =>
widen the spacing (rho up); below target => narrow. The parameterization
keeps the ladder sorted and positive BY CONSTRUCTION — no projection step.

Per-rung step sizes adapt jointly (the MMV'13 scheme's second update):
the eps_k = eps / sqrt(beta_k) default assumes the tempered target's
curvature scales exactly with beta — true for Gaussians, wrong for
mixtures (a flattened bimodal is WIDER than 1/sqrt(beta) predicts) and
funnels. The tuner learns a per-rung multiplicative correction on top of
the sqrt-beta law,

    eps_k = eps * scale_k / sqrt(beta_k),
    log scale_k <- log scale_k + eta_t * (A^rep_k - target_accept),

with rung 0 PINNED to the warmup-tuned cold step (scale_0 = 1: the
emitted chain keeps the operating point dual averaging already chose).
Because the correction rides on sqrt(beta_k), it auto-tracks the ladder
as the spacing update moves the temperatures under it.

Shape: each adaptation round is ONE jitted tempered scan
(`samplers/tempered.py::tempered_run` — the fused kernel, mesh
shard_map, everything the sampling phase uses) whose per-pair swap
acceptance and per-rung transition acceptance come back as (K-1,) / (K,)
vectors; the host loop only does the ~2K-scalar Robbins-Monro update
between rounds, exactly the host/device split the dual-averaging warmup
already uses (tuning/adaptation.py). The betas and step sizes enter
`tempered_run` as TRACED operands, so every round reuses one compiled
executable.
"""

from typing import Callable, Dict, Optional, Tuple

import numpy as np

DEFAULT_SWAP_TARGET = 0.234  # Atchade-Roberts-Rosenthal optimal PT swap rate


def spacings_to_betas(rho: np.ndarray) -> np.ndarray:
    """Map free log-spacings (K-1,) to a sorted ladder (K,) with beta_0=1."""
    rho = np.asarray(rho, np.float64)
    return np.exp(-np.concatenate([[0.0], np.cumsum(np.exp(rho))]))


def geometric_spacings(n_temps: int, beta_min: float) -> np.ndarray:
    """Log-spacings reproducing geometric_ladder(n_temps, beta_min)."""
    if n_temps < 2:
        raise ValueError("ladder tuning needs n_temps >= 2")
    if not 0.0 < beta_min < 1.0:
        raise ValueError("beta_min must be in (0, 1)")
    step = -np.log(beta_min) / (n_temps - 1)
    return np.full(n_temps - 1, np.log(step), np.float64)


def tune_ladder(
    run_round: Callable,
    n_temps: int,
    beta_min_init: float = 0.05,
    target_swap: float = DEFAULT_SWAP_TARGET,
    n_rounds: int = 24,
    learning_rate: float = 0.5,
    decay: float = 0.6,
    t0: float = 2.0,
    beta_floor: float = 1e-4,
    step_size: Optional[float] = None,
    target_accept: Optional[float] = None,
    step_learning_rate: float = 0.5,
    verbose: bool = False,
) -> Tuple[np.ndarray, Dict]:
    """Adapt the inverse-temperature ladder to uniform swap acceptance.

    run_round(betas: (K,) float32,
              step_sizes: (K,) float32 or None,
              replica_position or None)
        -> (swap_accept_rate: (K-1,),
            swap_attempts: (K-1,) or None,
            replica_accept_rate: (K,) or None,
            replica_final_positions)
    runs a short tempered sampling burst at the given ladder, continuing
    from the previous round's full (K*C, D) replica state — the caller
    decides the backend (XLA / fused Pallas / mesh shard_map) by closing
    over `tempered_run` or `tempered_run_sharded`.

    swap_attempts (tempered_run's info["swap_attempts"]) guards against a
    mis-sized burst: even/odd pairing means a burst must span at least two
    swap phases (num_samples >= 2 * swap_interval) or some pairs are never
    attempted — and an unattempted pair's rate reads 0, indistinguishable
    from always-rejected, which Robbins-Monro would dutifully drive toward
    zero spacing until the ladder degenerates. A zero-attempt pair on the
    first round raises; None skips the check (analytic acceptance models).

    step_size + target_accept (both set) enable joint per-rung step
    tuning: eps_k = step_size * scale_k / sqrt(beta_k) with scale_0
    pinned at 1 (the warmup-tuned cold step is not second-guessed) and
    log scale_{k>=1} Robbins-Monro'd toward target_accept using the
    round's replica_accept_rate. When disabled, run_round receives
    step_sizes=None and should apply its own default.

    Returns (betas, info). info carries the swap-rate history (pre/post
    deviation from target is the tuning's honest report card), the tuned
    per-rung step sizes (or None), the final replica positions (seed the
    sampling phase with them: the hot rungs are already equilibrated),
    and the spacing trace.
    """
    rho = geometric_spacings(n_temps, beta_min_init)
    tune_steps = step_size is not None and target_accept is not None
    log_scale = np.zeros(n_temps, np.float64)        # scale_0 pinned at 1
    log_floor = -np.log(beta_floor)
    replica_pos = None
    history = []

    def current_steps(betas):
        if not tune_steps:
            return None
        return (float(step_size) * np.exp(log_scale)
                / np.sqrt(betas.astype(np.float64))).astype(np.float32)

    for t in range(n_rounds):
        betas = spacings_to_betas(rho).astype(np.float32)
        steps = current_steps(betas)
        swap_rates, swap_attempts, replica_accept, replica_pos = run_round(
            betas, steps, replica_pos)
        swap_rates = np.asarray(swap_rates, np.float64)
        if swap_attempts is None:
            attempts = np.ones_like(swap_rates)
        else:
            attempts = np.asarray(swap_attempts, np.float64)
            if t == 0 and np.any(attempts <= 0):
                never = np.nonzero(attempts <= 0)[0].tolist()
                raise ValueError(
                    f"ladder burst never attempted adjacent pair(s) {never}"
                    " — the burst is shorter than one full even/odd swap"
                    " cycle; run bursts with num_samples >= 2 *"
                    " swap_interval")
        rec = {"betas": betas.tolist(), "swap_rates": swap_rates.tolist()}
        if replica_accept is not None:
            rec["replica_accept"] = np.asarray(replica_accept,
                                               np.float64).tolist()
        history.append(rec)
        eta = learning_rate / (t0 + t) ** decay
        # divergent hot rungs produce NaN acceptance and an unattempted
        # pair reads 0/0: update only the pairs with evidence, freeze the
        # rest rather than feed NaN (or a fake 0) into the spacings
        valid = np.isfinite(swap_rates) & (attempts > 0)
        if np.any(valid):
            rho = rho + np.where(valid,
                                 eta * (swap_rates - target_swap), 0.0)
            # keep the coldest rung above beta_floor by shrinking all
            # spacings proportionally (relative geometry is what the
            # update learned)
            total = float(np.sum(np.exp(rho)))
            if total > log_floor:
                rho = rho + np.log(log_floor / total)
        if verbose and not np.all(valid):
            print(f"  [ladder] round {t}: "
                  f"{int(np.sum(~valid))} pair(s) without finite attempted"
                  " swap evidence — their spacings frozen this round")
        if tune_steps and replica_accept is not None:
            acc = np.asarray(replica_accept, np.float64)
            ok = np.isfinite(acc)
            eta_s = step_learning_rate / (t0 + t) ** decay
            upd = np.where(ok, eta_s * (acc - target_accept), 0.0)
            upd[0] = 0.0                              # cold rung pinned
            log_scale = log_scale + upd
        if verbose:
            dev = float(np.mean(np.abs(swap_rates - target_swap)))
            print(f"  [ladder] round {t}: mean|A-{target_swap:.3f}|={dev:.3f}"
                  f" beta_min={spacings_to_betas(rho)[-1]:.4f}")
    betas = spacings_to_betas(rho).astype(np.float32)
    first = np.asarray(history[0]["swap_rates"], np.float64)
    last = np.asarray(history[-1]["swap_rates"], np.float64)
    info = {
        "betas": betas,
        "step_sizes": current_steps(betas),
        "replica_final_positions": replica_pos,
        "n_rounds": n_rounds,
        "target_swap": target_swap,
        "initial_deviation": float(np.mean(np.abs(first - target_swap))),
        "final_deviation": float(np.mean(np.abs(last - target_swap))),
        "history": history,
    }
    return betas, info
