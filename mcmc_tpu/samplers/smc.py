"""Annealed Sequential Monte Carlo (SMC sampler) with log-Z estimation.

Beyond-reference capability: the reference framework (and the rebuild's
other samplers) can only DRAW from a target — neither can estimate its
normalizing constant, and MCMC alone has no global tempering story beyond
replica exchange (samplers/tempered.py). Annealed SMC (Del Moral, Doucet &
Jasra 2006; AIS, Neal 2001) closes both gaps: a population of P particles
starts as exact draws from a tractable base p0 and is transported to the
target pi through the geometric bridge

    pi_b(x)  proportional to  p0(x)^(1-b) * exp(logp(x))^b,   b: 0 -> 1,

alternating importance reweighting (b -> b'), resampling when the weight
population degenerates, and MCMC moves targeting pi_b' (the framework's own
HMC/GRAHMC transition, samplers/grahmc.py::grahmc_step). The running
product of normalized-weight sums is an UNBIASED estimator of

    Z = integral exp(logp(x)) dx / integral p0(x) dx = integral exp(logp),

since the base is normalized — so with a normalized target log-prob the
estimate converges to log Z = 0 (a strong end-to-end correctness check the
test suite uses), and with an unnormalized one it measures the evidence.

Design: the particle population is ONE (P, D) batch — every
phase (reweight, conditional-ESS bisection, systematic resampling, mixture
leapfrog moves) is a batched primitive under one jit, with the adaptive
temperature loop as a lax.while_loop carrying static-shape history buffers.
Systematic resampling is a sorted-merge (cumsum + searchsorted) — O(P log P)
on device, no host round-trips anywhere. Particles are embarrassingly
parallel except for the weight normalization and resampling; the mesh
variant (parallel/fused_sharded.py::smc_run_sharded) psums the weight
reductions and keeps resampling island-local.

Adaptive schedule: the next inverse temperature is chosen on the fly so the
CONDITIONAL relative ESS of the reweight hits `target_rel_ess` (Jasra et
al. 2011 / Beskos et al. 2016) via a 30-step bisection — monotone in the
step, so the bisection is exact to float precision. A fixed ladder can be
passed instead for reproducible stage counts.

Step-size adaptation: each bridge distribution pi_b is a fresh MCMC
target whose leapfrog stability limit moves with beta, so the move step
follows a per-transition Robbins-Monro update toward 0.65 acceptance
(growth capped, shrink fast: the acceptance cliff at the stability limit
punishes overshoot far more than undershoot). Like the adaptive
temperature choice, this tunes kernel parameters from the current particle
population — the standard adaptive-SMC regime (consistent, asymptotically
unbiased; Beskos et al. 2016). For the EXACTLY unbiased estimator, pass a
fixed `betas` schedule with `adapt_step_size=False`.
"""

from functools import partial
from typing import Callable, NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import jit, lax, random

from mcmc_tpu import precision
from mcmc_tpu.samplers.base import ChainState, make_value_and_grad
from mcmc_tpu.ops.fused_trajectory import make_fused_grahmc_step
from mcmc_tpu.ops.padded_targets import kernel_family, resolve_backend
from mcmc_tpu.samplers.grahmc import grahmc_step
from mcmc_tpu.samplers.trajectory import mh_transition_dynamic

Array = jnp.ndarray

_BISECT_ITERS = 30          # ~1e-9 resolution on a unit interval
_STEP_RM_GAIN = 1.0         # Robbins-Monro gain for between-stage step tuning
_TARGET_MOVE_ACCEPT = 0.65  # HMC-family optimum (reference parity constant)


class SMCResult(NamedTuple):
    """Annealed-SMC output.

    particles:   (P, D) final particle positions (weighted unless the run
                 finished with a resample — check info['ess'])
    log_weights: (P,) normalized log-weights of `particles`
                 (logsumexp == 0)
    log_Z:       scalar — unbiased-in-Z estimate of log integral exp(logp)
    final_state: ChainState of the last move phase (mixture log-probs at
                 beta == 1, i.e. the target's)
    info:        betas / rel_ess / accept / resampled / step_size per stage
                 (static max_stages buffers + n_stages), n_resamples,
                 final ess
    """
    particles: Array
    log_weights: Array
    log_Z: Array
    final_state: ChainState
    info: dict


def gaussian_base(dim: int, mean=None, scale=1.0):
    """Normalized spherical-Gaussian base N(mean, scale^2 I): the default
    p0 for the geometric bridge. Returns (sampler, log_prob, value_and_grad)
    with the framework's batched (P, D) calling convention."""
    mean = jnp.zeros(dim, jnp.float32) if mean is None else (
        jnp.broadcast_to(jnp.asarray(mean, jnp.float32), (dim,)))
    scale = jnp.broadcast_to(jnp.asarray(scale, jnp.float32), (dim,))
    if (not isinstance(scale, jax.core.Tracer)
            and bool(np.any(np.asarray(scale) <= 0.0))):
        raise ValueError("base scale must be strictly positive")
    log_norm = -jnp.sum(jnp.log(scale)) - 0.5 * dim * jnp.log(2.0 * jnp.pi)

    def sampler(key, n):
        return mean + scale * random.normal(key, (n, dim), jnp.float32)

    def log_prob(x):
        z = (x - mean.astype(x.dtype)) / scale.astype(x.dtype)
        return -0.5 * jnp.sum(z * z, axis=-1) + log_norm.astype(x.dtype)

    def value_and_grad(x):
        z = (x - mean.astype(x.dtype)) / scale.astype(x.dtype)
        lp = -0.5 * jnp.sum(z * z, axis=-1) + log_norm.astype(x.dtype)
        return lp, -z / scale.astype(x.dtype)

    return sampler, log_prob, value_and_grad


def systematic_resample(key, log_weights: Array) -> Array:
    """Systematic resampling: indices (P,) such that particle i is copied
    floor(P*w_i) or ceil(P*w_i) times (minimum-variance unbiased among
    single-uniform schemes). One cumsum + one searchsorted on device.

    log_weights need not be normalized (normalized internally)."""
    n = log_weights.shape[0]
    lw = log_weights - jax.scipy.special.logsumexp(log_weights)
    cdf = jnp.cumsum(jnp.exp(lw))
    # guard the tail against rounding: cdf[-1] must dominate every point
    cdf = cdf.at[-1].set(jnp.asarray(1.0, cdf.dtype) + 1e-6)
    u = random.uniform(key, (), dtype=cdf.dtype) / n
    points = u + jnp.arange(n, dtype=cdf.dtype) / n
    return jnp.clip(jnp.searchsorted(cdf, points), 0, n - 1)


def _lse(x: Array, axis_name: Optional[str] = None) -> Array:
    """logsumexp over the particle population. With `axis_name`, x is the
    DEVICE-LOCAL shard and the reduction spans the mesh axis: one pmax for
    the shift, one psum for the sum — the only collectives annealed SMC
    needs (the particles themselves never move between devices)."""
    if axis_name is None:
        return jax.scipy.special.logsumexp(x)
    m = lax.pmax(jnp.max(x), axis_name)
    m_safe = jnp.where(jnp.isfinite(m), m, jnp.zeros_like(m))
    s = lax.psum(jnp.sum(jnp.exp(x - m_safe)), axis_name)
    return jnp.log(s) + m_safe


def _rel_ess(log_weights: Array, total: Optional[int] = None,
             axis_name: Optional[str] = None) -> Array:
    """Relative effective sample size of NORMALIZED log-weights:
    1 / (P * sum w_i^2), in (0, 1]. `total` is the GLOBAL particle count
    when `log_weights` is a device-local shard."""
    n = total if total is not None else log_weights.shape[0]
    return jnp.exp(-_lse(2.0 * log_weights, axis_name)) / n


def _validate_beta_schedule(betas) -> None:
    """A bad explicit schedule must error loudly: betas[-1] != 1 estimates
    the WRONG constant (Z of pi^b_last), non-ascending steps make the
    incremental weights estimate nothing meaningful."""
    b = np.asarray(betas, np.float64)
    if b.ndim != 1 or b.size < 1:
        raise ValueError(f"betas must be a 1-D schedule, got shape {b.shape}")
    if not np.all(np.isfinite(b)) or b[0] <= 0.0:
        raise ValueError(f"betas must be finite with betas[0] > 0: {b}")
    if abs(b[-1] - 1.0) > 1e-6:
        raise ValueError("betas[-1] must be 1.0 (the target; anything else "
                         f"estimates Z of pi^beta instead), got {b[-1]}")
    if b.size > 1 and np.any(np.diff(b) <= 0.0):
        raise ValueError(f"betas must be strictly ascending: {b}")


def smc_run(
    key,
    log_prob_fn,
    n_particles: int,
    dim: int,
    step_size,
    num_steps: int,
    betas: Optional[Array] = None,
    target_rel_ess: float = 0.5,
    resample_threshold: float = 0.5,
    move_steps: int = 3,
    max_stages: int = 200,
    base_mean=None,
    base_scale=1.0,
    inv_mass_matrix: Optional[Array] = None,
    gamma=0.0,
    steepness=1.0,
    friction_schedule: Optional[Callable] = None,
    value_and_grad_fn: Optional[Callable] = None,
    adapt_step_size: bool = True,
    final_resample: bool = False,
    tune_trajectory: bool = False,
    max_leapfrogs: Optional[int] = None,
    move_backend: str = "auto",
) -> SMCResult:
    """Annealed SMC from N(base_mean, base_scale^2 I) to exp(log_prob_fn).

    betas: explicit ascending schedule ending at 1.0 (stage b-values AFTER
    each reweight), or None for the adaptive conditional-ESS schedule
    (next b chosen so the reweight's relative conditional ESS ==
    target_rel_ess, capped at max_stages stages).
    move_steps: MCMC transitions per stage (each of num_steps leapfrogs)
    through grahmc_step (plain HMC when friction_schedule is None).
    resample_threshold: systematic-resample when rel. ESS drops below this.
    adapt_step_size: per-transition Robbins-Monro step tuning toward 0.65
    acceptance (adaptive-SMC regime: consistent; disable together with a
    fixed `betas` schedule for the exactly unbiased estimator).
    final_resample: return an unweighted (uniform-weight) population.
    tune_trajectory: adapt the move TRAJECTORY LENGTH alongside the step
    size with the ChEES criterion computed on the particle population
    (Hoffman-Radul-Sountsov 2021; the SMC composition follows Devlin et
    al. 2025, arXiv:2504.02627 "Incorporating the ChEES Criterion into
    Sequential Monte Carlo Samplers"): each move draws a uniform jitter
    h, integrates ceil(h*T/eps) leapfrogs (traced count — one compiled
    program), and Adam-ascends log T on the acceptance-weighted criterion
    gradient (tuning/chees.py::chees_log_t_grad). Each bridge distribution
    pi_b has its own optimal T, exactly like its own stability cliff —
    this tracks both. `num_steps` then only sets the INITIAL length
    T0 = num_steps * step_size; the realized leapfrog count is returned
    in info["n_leapfrogs"] (per particle) and the per-stage T in
    info["trajectory_length"]. Same adaptive-SMC consistency regime as
    adapt_step_size.
    max_leapfrogs: cap on the per-move leapfrog count when tuning
    (default max(4 * num_steps, 16)).
    move_backend: 'xla' runs the fixed-length moves through the scan-based
    grahmc_step; 'pallas' fuses each move into ONE bridge-kernel call
    (ops/fused_trajectory.py — the beta-mixture target evaluated inside
    the kernel; requires an analytic value_and_grad_fn with kernel math
    and the fixed-length path); 'interpret' runs that kernel under the
    Pallas interpreter. 'auto' picks pallas whenever those conditions hold
    and the backend resolver (ops/padded_targets.resolve_backend) picks
    the kernel. The kernel path splits its move keys differently from
    grahmc_step, so the two backends draw different (equally valid)
    streams.

    Returns SMCResult; see the module docstring for the estimator contract.
    Cited against the reference's missing capability: its bimodal benchmark
    works around multimodality with a split-mode init_sampler (reference
    benchmarks/targets.py:456-465) and nothing in the reference estimates
    normalizing constants.
    """
    if betas is not None and not isinstance(betas, jax.core.Tracer):
        _validate_beta_schedule(betas)
        betas = jnp.asarray(betas, jnp.float32)
        if int(betas.shape[0]) > max_stages:
            max_stages = int(betas.shape[0])
    if n_particles < 2:
        raise ValueError("n_particles must be >= 2")
    if not 0.0 < target_rel_ess < 1.0:
        raise ValueError("target_rel_ess must be in (0, 1)")
    if (base_scale is not None and not isinstance(base_scale, jax.core.Tracer)
            and bool(np.any(np.asarray(base_scale) <= 0.0))):
        raise ValueError("base_scale must be strictly positive")
    if max_leapfrogs is None:
        max_leapfrogs = max(4 * num_steps, 16)
    move_backend = resolve_move_backend(move_backend, value_and_grad_fn,
                                        tune_trajectory, inv_mass_matrix)
    return _smc_run_jit(
        key, log_prob_fn, n_particles=n_particles, dim=dim,
        step_size=step_size, num_steps=num_steps, betas=betas,
        target_rel_ess=target_rel_ess, resample_threshold=resample_threshold,
        move_steps=move_steps, max_stages=max_stages, base_mean=base_mean,
        base_scale=base_scale, inv_mass_matrix=inv_mass_matrix, gamma=gamma,
        steepness=steepness, friction_schedule=friction_schedule,
        value_and_grad_fn=value_and_grad_fn, adapt_step_size=adapt_step_size,
        final_resample=final_resample, tune_trajectory=tune_trajectory,
        max_leapfrogs=max_leapfrogs, move_backend=move_backend)


def resolve_move_backend(move_backend: str, value_and_grad_fn,
                         tune_trajectory: bool, inv_mass_matrix) -> str:
    """'auto' -> the backend resolver's choice (ops/padded_targets.
    resolve_backend: the kernel on a GPU for targets with kernel math),
    but only for fixed-length moves (the ChEES-tuned dynamic path stays
    XLA) and a diagonal (or absent) metric — the bridge kernel supports
    dense metrics too, but SMC never learns one, so auto keeps the
    decision simple. Explicit 'pallas'/'interpret' assert the
    preconditions loudly instead."""
    if move_backend == "auto":
        dense = (inv_mass_matrix is not None
                 and jnp.ndim(inv_mass_matrix) == 2)
        if tune_trajectory or dense:
            return "xla"
    resolved = resolve_backend(move_backend, value_and_grad_fn)
    if move_backend in ("pallas", "interpret"):
        if tune_trajectory:
            raise ValueError(
                f"move_backend={move_backend!r} fuses the fixed-length move "
                "path; tune_trajectory uses the XLA dynamic-length "
                "transition")
        if kernel_family(value_and_grad_fn) is None:
            raise TypeError(
                f"move_backend={move_backend!r} needs an analytic "
                "value_and_grad_fn with kernel math (a mcmc_tpu.targets "
                "factory of ops/padded_targets.KERNEL_FAMILIES)")
    return resolved


@partial(jit, static_argnames=(
    "log_prob_fn", "n_particles", "dim", "num_steps", "move_steps",
    "max_stages", "friction_schedule", "value_and_grad_fn",
    "adapt_step_size", "final_resample", "axis_name", "total_particles",
    "tune_trajectory", "max_leapfrogs", "move_backend"))
def _smc_run_jit(
    key,
    log_prob_fn,
    n_particles: int,
    dim: int,
    step_size,
    num_steps: int,
    betas: Optional[Array],
    target_rel_ess: float,
    resample_threshold: float,
    move_steps: int,
    max_stages: int,
    base_mean,
    base_scale,
    inv_mass_matrix,
    gamma,
    steepness,
    friction_schedule,
    value_and_grad_fn,
    adapt_step_size: bool,
    final_resample: bool,
    axis_name: Optional[str] = None,
    total_particles: Optional[int] = None,
    tune_trajectory: bool = False,
    max_leapfrogs: int = 16,
    jitter_key=None,
    move_backend: str = "xla",
) -> SMCResult:
    """With `axis_name` set (called per-device inside shard_map, see
    parallel/fused_sharded.py::smc_run_sharded), `n_particles` is the
    DEVICE-LOCAL shard size and `total_particles` the global population:
    every weight reduction (reweight normalization, log-Z increments,
    ESS, the conditional-ESS bisection) spans the mesh via _lse psums, so
    the adaptive temperature loop takes IDENTICAL branches on every
    device, while resampling stays island-local (each device resamples
    its shard and carries the island's total weight forward — the
    unbiased distributed-resampling scheme of Vergé et al. 2015)."""
    P, D = n_particles, dim
    PT = total_particles if total_particles is not None else P
    e_dtype = precision.energy_dtype()
    base_sampler, _base_lp, base_vag = gaussian_base(D, base_mean, base_scale)
    target_vag = make_value_and_grad(log_prob_fn, value_and_grad_fn)

    fused = move_backend != "xla"
    if fused:
        # One fused bridge-kernel call per move: the beta-mixture target
        # (ops/fused_trajectory.py `bridged` variant) is evaluated inside
        # the kernel across all num_steps leapfrogs — the same kernel the
        # plain GRAHMC path uses.
        fused_move = make_fused_grahmc_step(
            log_prob_fn, value_and_grad_fn, num_steps, friction_schedule,
            backend=move_backend)
        bmean_arr = (jnp.zeros(D, jnp.float32) if base_mean is None
                     else jnp.broadcast_to(
                         jnp.asarray(base_mean, jnp.float32), (D,)))
        bscale_arr = jnp.broadcast_to(
            jnp.asarray(base_scale, jnp.float32), (D,))

    key, k_init = random.split(key)
    q0 = base_sampler(k_init, P)
    lp_t0, g_t0 = target_vag(q0)
    lp_b0, g_b0 = base_vag(q0)

    fixed = betas is not None
    if fixed:
        sched = jnp.concatenate([jnp.asarray(betas, jnp.float32),
                                 jnp.ones(max_stages - betas.shape[0],
                                          jnp.float32)])
        n_fixed = betas.shape[0]
    else:
        sched = jnp.ones(max_stages, jnp.float32)   # unused placeholder
        n_fixed = max_stages

    def pick_beta(beta, logw, ll, stage):
        """Next inverse temperature. Fixed schedule: indexed lookup.
        Adaptive: largest delta whose conditional rel-ESS still meets
        target_rel_ess (monotone decreasing in delta -> exact bisection);
        a full jump to 1 is taken whenever it already meets the target."""
        if fixed:
            return sched[jnp.minimum(stage, n_fixed - 1)]

        def cond_ess(delta):
            w = logw + delta.astype(logw.dtype) * ll
            return _rel_ess(w - _lse(w, axis_name), PT, axis_name)

        full = jnp.asarray(1.0, jnp.float32) - beta
        meets_at_full = cond_ess(full) >= target_rel_ess

        def bisect(_, lo_hi):
            lo, hi = lo_hi
            mid = 0.5 * (lo + hi)
            ok = cond_ess(mid) >= target_rel_ess
            return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

        lo, _hi = lax.fori_loop(0, _BISECT_ITERS, bisect,
                                (jnp.asarray(0.0, jnp.float32), full))
        # lo == 0 can only happen if even an infinitesimal step fails the
        # target (pathological ll spread): force minimal progress so the
        # loop cannot stall below max_stages
        delta = jnp.where(meets_at_full, full,
                          jnp.maximum(lo, full / max_stages))
        return beta + delta

    class Carry(NamedTuple):
        key: Array
        q: Array
        lp_t: Array      # target log-prob at q (energy dtype)
        g_t: Array       # target grad at q (position dtype)
        logw: Array      # normalized log-weights (energy dtype)
        log_z: Array
        beta: Array
        eps: Array       # current move step size
        stage: Array     # stages completed
        n_resamples: Array
        n_divergences: Array
        cs_t: tuple      # ChEES Adam-on-log-T state (constant when off)
        jkey: Array      # jitter stream (REPLICATED under a mesh)
        n_leapfrogs: Array  # realized per-particle leapfrogs (tuned path)
        hist: dict

    def stage_step(c: Carry) -> Carry:
        key, kr, km = random.split(c.key, 3)
        lp_b, g_b = base_vag(c.q)
        ll = c.lp_t - lp_b.astype(e_dtype)

        b_new = pick_beta(c.beta, c.logw, ll, c.stage)
        delta = (b_new - c.beta).astype(e_dtype)

        # reweight + unbiased log-Z increment (logw stays normalized)
        w = c.logw + delta * ll
        incr = _lse(w, axis_name)
        logw = w - incr
        log_z = c.log_z + incr
        rel = _rel_ess(logw, PT, axis_name)

        # systematic resample when degenerate (global decision — identical
        # on every device; the resample itself is island-local: each
        # island's post-resample particles share its pre-resample total
        # weight, so no particle ever crosses a device boundary). The
        # whole resample lives under lax.cond: most stages keep their
        # population, and the skipped branch saves the cumsum/searchsorted
        # plus five (P, D)-class gathers per stage. Taken-branch results
        # are bit-identical to the old unconditional-where formulation
        # (same kr stream).
        do_res = rel < resample_threshold

        def _resample(args):
            q0, lpt0, gt0, lpb0, gb0, lw0 = args
            idx = systematic_resample(kr, lw0)
            if axis_name is None:
                lw_reset = jnp.full_like(lw0, -jnp.log(float(P)))
            else:
                island = jax.scipy.special.logsumexp(lw0)  # local shard sum
                lw_reset = jnp.full_like(lw0, island - jnp.log(float(P)))
            return (q0[idx], lpt0[idx], gt0[idx], lpb0[idx], gb0[idx],
                    lw_reset)

        q, lp_t, g_t, lp_b, g_b, logw = lax.cond(
            do_res, _resample, lambda args: args,
            (c.q, c.lp_t, c.g_t, lp_b, g_b, logw))

        # MCMC moves targeting pi_{b_new} (mixture built from cached
        # target/base pieces -- no extra evals to form the state)
        bb = b_new.astype(e_dtype)
        bp = b_new.astype(q.dtype)

        def mixture_vag(x):
            lt, gt = target_vag(x)
            lb, gb = base_vag(x)
            return (bb * lt.astype(e_dtype)
                    + (1.0 - bb) * lb.astype(e_dtype),
                    bp * gt.astype(x.dtype) + (1.0 - bp) * gb.astype(x.dtype))

        mstate = ChainState(
            position=q,
            log_prob=bb * lp_t + (1.0 - bb) * lp_b.astype(e_dtype),
            grad_log_prob=bp * g_t + (1.0 - bp) * g_b.astype(q.dtype),
            accept_count=jnp.zeros(P, jnp.int32),
            divergence_count=jnp.zeros(P, jnp.int32))

        def _eps_update(eps_l, acc_t):
            """Robbins-Monro eps update from ONE transition's acceptance.
            Asymmetric — growth capped at e^0.05, shrink up to e^-1 —
            because leapfrog acceptance CLIFFS at the stability limit
            (measured on the ill-conditioned bridge: eps 1.89 -> 0.92
            acceptance, eps 2.17 -> 0.002): a symmetric gain oscillates
            across the cliff, and a between-stage-only update wastes an
            entire stage's moves every time the bridge geometry shifts
            the cliff (the dominant failure at few-stage schedules)."""
            if not adapt_step_size:
                return eps_l
            raw = _STEP_RM_GAIN * (acc_t - _TARGET_MOVE_ACCEPT)
            return eps_l * jnp.exp(jnp.clip(raw, -1.0, 0.05))

        def one_move(carry, _):
            """One pi_b-invariant transition + per-transition adaptation
            (eps always; log T via the ChEES criterion when tuning)."""
            mk, st, eps_l, cs_t, jk, n_lf = carry
            if not tune_trajectory:
                prev = st.accept_count
                if fused:
                    mk, st, _extras = fused_move(
                        mk, st, eps_l, gamma, steepness, inv_mass,
                        bridge=(b_new, bmean_arr, bscale_arr))
                else:
                    mk, st, _extras = grahmc_step(
                        mk, st, mixture_vag, eps_l, num_steps, gamma=gamma,
                        steepness=steepness, inv_mass_matrix=inv_mass,
                        friction_schedule=friction_schedule)
                acc_t = (st.accept_count - prev).astype(jnp.float32).mean()
                n_lf = n_lf + jnp.int32(num_steps)
            else:
                # jittered dynamic-length transition (the shared
                # trajectory.py::mh_transition_dynamic — one
                # implementation with tuning/chees.py): n = ceil(h*T/eps)
                # leapfrogs as a TRACED count, one compiled program
                # across all T values. The jitter stream jk is replicated
                # across devices so every device runs the same n.
                from mcmc_tpu.tuning.chees import (
                    chees_log_t_grad, chees_update, num_leapfrog_steps)
                q0 = st.position
                jk, k_h = random.split(jk)
                h = random.uniform(k_h, (), dtype=jnp.float32)
                T = jnp.exp(cs_t.log_t).astype(jnp.float32)
                n = num_leapfrog_steps(h * T, eps_l, max_leapfrogs)
                mk, st, acc_mask, q1, p1, log_alpha, _div = \
                    mh_transition_dynamic(
                        mk, st, mixture_vag, eps_l, n, inv_mass,
                        friction_schedule=friction_schedule,
                        gamma_max=gamma, steepness=steepness)
                # criterion gradient needs the UNFLIPPED endpoint momentum
                alpha = jnp.exp(log_alpha).astype(jnp.float32)
                g = chees_log_t_grad(q0, q1, p1, h, T, alpha,
                                     inv_mass, axis_name=axis_name)
                cs_t = chees_update(cs_t, g)
                acc_t = acc_mask.astype(jnp.float32).mean()
                n_lf = n_lf + n
            if axis_name is not None:
                # global acceptance: the eps trajectory must be identical
                # on every device (equal shard sizes -> pmean is exact)
                acc_t = lax.pmean(acc_t, axis_name)
            eps_l = _eps_update(eps_l, acc_t)
            return (mk, st, eps_l, cs_t, jk, n_lf), acc_t

        (_, mstate, eps, cs_t, jkey, n_lf), acc_ts = lax.scan(
            one_move, (km, mstate, c.eps, c.cs_t, c.jkey, c.n_leapfrogs),
            None, length=move_steps)
        accept = acc_ts.mean()

        # refresh the target pieces at the moved positions directly (one
        # extra eval per stage, ~1/(num_steps*move_steps) of the move cost)
        # rather than un-mixing the state's mixture log-prob: the un-mix
        # divides by b_new, which amplifies float32 rounding by 1/b at the
        # small-beta early stages
        lp_t2, g_t2 = target_vag(mstate.position)
        lp_t2 = lp_t2.astype(e_dtype)
        g_t2 = g_t2.astype(q.dtype)

        s = c.stage
        hist = {
            "betas": c.hist["betas"].at[s].set(b_new),
            "rel_ess": c.hist["rel_ess"].at[s].set(rel.astype(jnp.float32)),
            "accept": c.hist["accept"].at[s].set(accept),
            "resampled": c.hist["resampled"].at[s].set(do_res),
            "step_size": c.hist["step_size"].at[s].set(
                c.eps.astype(jnp.float32)),
            "trajectory_length": c.hist["trajectory_length"].at[s].set(
                jnp.exp(c.cs_t.log_t).astype(jnp.float32)),
        }
        return Carry(key, mstate.position, lp_t2, g_t2, logw, log_z, b_new,
                     eps, s + 1, c.n_resamples + do_res.astype(jnp.int32),
                     c.n_divergences + jnp.sum(
                         mstate.divergence_count).astype(jnp.int32),
                     cs_t, jkey, n_lf, hist)

    inv_mass = (jnp.ones(D, q0.dtype) if inv_mass_matrix is None
                else jnp.asarray(inv_mass_matrix, q0.dtype))

    # ChEES trajectory-length state: Adam on log T starting from the
    # fixed-path length T0 = num_steps * eps. The jitter stream is split
    # off only in tuning mode so the default path's RNG (and every
    # archived default-run result) is bit-unchanged.
    from mcmc_tpu.tuning.chees import chees_init
    cs_t0 = chees_init(jnp.maximum(
        jnp.asarray(step_size, jnp.float32) * num_steps, 1e-6),
        dtype=jnp.float32)
    if tune_trajectory:
        if jitter_key is not None:
            jkey0 = jitter_key
        else:
            key, jkey0 = random.split(key)
    else:
        jkey0 = random.PRNGKey(0)        # placeholder, never consumed

    hist0 = {
        "betas": jnp.zeros(max_stages, jnp.float32),
        "rel_ess": jnp.zeros(max_stages, jnp.float32),
        "accept": jnp.zeros(max_stages, jnp.float32),
        "resampled": jnp.zeros(max_stages, bool),
        "step_size": jnp.zeros(max_stages, jnp.float32),
        "trajectory_length": jnp.zeros(max_stages, jnp.float32),
    }
    c0 = Carry(
        key=key, q=q0, lp_t=lp_t0.astype(e_dtype),
        g_t=g_t0.astype(q0.dtype),
        logw=jnp.full(P, -jnp.log(float(PT)), e_dtype),
        log_z=jnp.asarray(0.0, e_dtype),
        beta=jnp.asarray(0.0, jnp.float32),
        eps=jnp.asarray(step_size, jnp.float32),
        stage=jnp.asarray(0, jnp.int32),
        n_resamples=jnp.asarray(0, jnp.int32),
        n_divergences=jnp.asarray(0, jnp.int32),
        cs_t=cs_t0, jkey=jkey0,
        n_leapfrogs=jnp.asarray(0, jnp.int32),
        hist=hist0)

    n_run = n_fixed if fixed else max_stages
    c = lax.while_loop(
        lambda c: (c.beta < 1.0) & (c.stage < n_run), stage_step, c0)

    logw = c.logw
    q = c.q
    lp_t = c.lp_t
    g_t = c.g_t
    if final_resample:
        key, kf = random.split(c.key)
        idx = systematic_resample(kf, logw)
        if axis_name is None:
            logw_final = jnp.full(P, -jnp.log(float(P)), e_dtype)
        else:
            logw_final = jnp.full(
                P, jax.scipy.special.logsumexp(logw) - jnp.log(float(P)),
                e_dtype)
        q, lp_t, g_t = q[idx], lp_t[idx], g_t[idx]
        logw = logw_final

    final_state = ChainState(
        position=q, log_prob=lp_t, grad_log_prob=g_t,
        accept_count=jnp.zeros(P, jnp.int32),
        divergence_count=jnp.zeros(P, jnp.int32))
    n_div = c.n_divergences
    if axis_name is not None:
        n_div = lax.psum(n_div, axis_name)
    info = {
        "n_stages": c.stage,
        "n_resamples": c.n_resamples,
        "n_divergences": n_div,
        "ess": _rel_ess(logw, PT, axis_name) * PT,
        "final_step_size": c.eps,
        # realized leapfrogs PER PARTICLE (every particle integrates the
        # same count each move; fixed path = stages * moves * num_steps)
        "n_leapfrogs": c.n_leapfrogs,
        "final_trajectory_length": jnp.exp(c.cs_t.log_t),
        **c.hist,
    }
    return SMCResult(q, logw, c.log_z, final_state, info)


def weighted_moments(particles: Array, log_weights: Array):
    """Self-normalized importance estimates (mean (D,), covariance (D, D))
    of the final weighted population — the standard consumer of SMCResult."""
    w = jnp.exp(log_weights - jax.scipy.special.logsumexp(log_weights))
    mean = jnp.sum(w[:, None] * particles, axis=0)
    d = particles - mean
    cov = jnp.einsum("p,pi,pj->ij", w, d, d)
    return mean, cov
