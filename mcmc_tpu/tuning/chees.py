"""ChEES: cross-chain trajectory-length adaptation for HMC / GRAHMC.

Implements the ChEES criterion (Change in the Estimator of the Expected
Square) of Hoffman, Radul & Sountsov, "An Adaptive-MCMC Scheme for Setting
Trajectory Lengths in Hamiltonian Monte Carlo" (AISTATS 2021): maximize

    ChEES(T) = (1/4) E[ (||q' - mu'||^2 - ||q - mu||^2)^2 ]

over the trajectory length T, where q'/q are proposed/current states and
mu'/mu their cross-chain means. Each iteration samples a jittered length
t = h * T (h quasirandom in (0,1), SHARED by all chains), runs all chains
for the same leapfrog count, and ascends d ChEES / d log T with Adam using
the per-chain gradient estimate

    g_i = h * T * alpha_i * c_i * <q'_i - mu', v'_i>,
    c_i = ||q'_i - mu'||^2 - ||q_i - mu||^2,   v' = dq'/dt = M^{-1} p'

(alpha_i the MH acceptance probability; norms computed in the mass-matrix-
sphered space so the criterion is scale-free under preconditioning).

Why this replaces the reference's L grid search: the reference selects the
trajectory length by running the FULL warmup+sampling pipeline once per
candidate L (reference run_benchmarks.py:1055-1056: 7 candidates) and
keeping the best bulk-ESS/gradient. ChEES folds the selection into ONE
warmup run. It is also the natural batched formulation of the problem: the
criterion's cross-chain expectations need many chains to be low-variance
per iteration — exactly the thousands-of-SPMD-chains regime this framework
targets — and the shared jitter keeps every iteration a dense
(n_chains, dim) block with a single dynamic trip-count while_loop (no
per-chain control flow, nothing for XLA to unroll badly). Under a chain
mesh the two cross-chain means are each one `pmean` per iteration.

Step size is tuned concurrently by the same dual-averaging core as the
windowed warmup (tuning/dual_averaging.py), and the diagonal mass matrix by
the same Welford windows — `run_chees_warmup` is a drop-in alternative to
`run_adaptive_warmup` returning the same (step_size, inv_mass, position,
info) tuple, with the tuned trajectory in info["trajectory_length"] /
info["num_steps"].
"""

from functools import partial
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax, random

from mcmc_tpu.samplers.base import make_value_and_grad, init_chain_state
from mcmc_tpu.samplers.trajectory import mh_transition_dynamic
from mcmc_tpu.tuning.adaptation import build_schedule, fixed_width_batches
from mcmc_tpu.tuning.dual_averaging import (
    da_init, da_update, da_reset, da_step_size, da_final_step_size)
from mcmc_tpu.tuning.welford import (
    welford_init, welford_update, chain_averaged_variance, shrink_variance,
    dense_moment_init, dense_moment_update, dense_covariance,
    shrink_covariance, psum_increment)

Array = jnp.ndarray

CHEES_ADAM_LR = 0.025          # paper's Adam learning rate on log T
CHEES_ADAM_EPS = 1e-8
DEFAULT_MAX_STEPS = 256        # hard cap on leapfrogs per jittered trajectory

# Joint GRAHMC friction adaptation (round 4, VERDICT r3 #8): two-sided
# SPSA on log gamma, interleaved with the ChEES/DA/Welford updates, so ONE
# warmup produces (eps, M, T, gamma) — replacing the separate coarse
# ESJD grid phase the reference itself deprecates (reference
# tuning/dual_averaging.py:683-708). Steps alternate gamma*e^{+delta} /
# gamma*e^{-delta}; each DA batch turns the two acceptance-weighted
# sphered-ESJD means into d log ESJD / d log gamma and takes one clipped
# Robbins-Monro step. Bounds: the reference joint-DA path clips gamma to
# [0.01, 50] (reference tuning/dual_averaging.py:509); we deliberately use
# the tighter [0.01, 20] — friction above ~20 is outside every schedule's
# useful range and a looser cap only slows the pin-at-bound fallback test.
GAMMA_SPSA_DELTA = 0.3         # log-space probe half-width (+-35%)
GAMMA_SPSA_LR = 0.4            # RM gain per DA batch on log gamma
GAMMA_MIN, GAMMA_MAX = 0.01, 20.0


class GammaSPSAState(NamedTuple):
    """Per-batch accumulator for the two-sided friction probe.

    log_gamma: current RM iterate (replicated under a mesh).
    sum_p/sum_m: acceptance-weighted sphered-ESJD sums at the +/- probes.
    n_p/n_m: live step counts behind each sum (dead batch-padding steps
    advance neither, so the +- alternation stays exact across batches)."""
    log_gamma: Array
    sum_p: Array
    sum_m: Array
    n_p: Array
    n_m: Array


def gamma_spsa_init(gamma: float, dtype=jnp.float32) -> GammaSPSAState:
    g0 = float(np.clip(gamma if gamma and gamma > 0 else 1.0,
                       GAMMA_MIN, GAMMA_MAX))
    z = jnp.asarray(0.0, dtype)
    return GammaSPSAState(jnp.asarray(np.log(g0), dtype), z, z, z, z)


def gamma_spsa_batch_update(gs: GammaSPSAState,
                            lr: float = GAMMA_SPSA_LR,
                            delta: float = GAMMA_SPSA_DELTA
                            ) -> GammaSPSAState:
    """One RM step on log gamma from a finished batch's probe sums.

    The gradient estimate is (log E+ - log E-) / (2 delta) — the log makes
    it scale-free, so one gain works across targets. Skipped (iterate
    kept) when either side saw no live steps or a degenerate sum."""
    e_p = gs.sum_p / jnp.maximum(gs.n_p, 1.0)
    e_m = gs.sum_m / jnp.maximum(gs.n_m, 1.0)
    ok = (gs.n_p > 0) & (gs.n_m > 0) & (e_p > 0) & (e_m > 0)
    g_hat = (jnp.log(jnp.maximum(e_p, 1e-30))
             - jnp.log(jnp.maximum(e_m, 1e-30))) / (2.0 * delta)
    new_lg = jnp.clip(gs.log_gamma + lr * jnp.clip(g_hat, -2.0, 2.0),
                      np.log(GAMMA_MIN), np.log(GAMMA_MAX))
    z = jnp.zeros_like(gs.sum_p)
    return GammaSPSAState(jnp.where(ok, new_lg, gs.log_gamma), z, z, z, z)


def halton_sequence(n: int, offset: int = 0) -> np.ndarray:
    """First `n` points of the base-2 radical-inverse (van der Corput)
    sequence, skipping `offset` — the quasirandom jitter stream. Host-side;
    the values are scan inputs, not traced computation."""
    idx = np.arange(offset + 1, offset + n + 1, dtype=np.uint64)
    out = np.zeros(n, dtype=np.float64)
    denom = 1.0
    while idx.any():
        denom *= 2.0
        out += (idx & 1) / denom
        idx >>= 1
    return out


class ChEESState(NamedTuple):
    """Adam-on-log-T state. All leaves are scalars (replicated under a
    mesh, like the DA state)."""
    log_t: Array
    m: Array       # first-moment EMA
    v: Array       # second-moment EMA
    count: Array   # update count (bias correction)


def chees_init(initial_trajectory_length, dtype=jnp.float64) -> ChEESState:
    z = jnp.zeros((), dtype)
    return ChEESState(
        log_t=jnp.asarray(jnp.log(initial_trajectory_length), dtype),
        m=z, v=z, count=z)


def chees_update(state: ChEESState, grad, lr=CHEES_ADAM_LR,
                 beta1=0.9, beta2=0.999) -> ChEESState:
    """One Adam ASCENT step on log T. The raw criterion gradient's scale is
    problem-dependent; Adam's second-moment normalization makes the update
    scale-free, so no explicit gradient normalization is needed."""
    count = state.count + 1.0
    grad = jnp.where(jnp.isfinite(grad), grad, 0.0)  # belt-and-braces
    m = beta1 * state.m + (1.0 - beta1) * grad
    v = beta2 * state.v + (1.0 - beta2) * grad * grad
    mhat = m / (1.0 - beta1 ** count)
    vhat = v / (1.0 - beta2 ** count)
    log_t = state.log_t + lr * mhat / (jnp.sqrt(vhat) + CHEES_ADAM_EPS)
    return ChEESState(log_t=log_t, m=m, v=v, count=count)


CHEES_WINSOR_MULT = 10.0   # clip per-chain gradients at this x median |g|


def chees_log_t_grad(q0: Array, q1: Array, p1: Array, h, trajectory_length,
                     alpha: Array, inv_mass: Array,
                     axis_name: Optional[str] = None,
                     winsorize: float = CHEES_WINSOR_MULT) -> Array:
    """Acceptance-weighted cross-chain estimate of d ChEES / d log T.

    q0/q1: (C, D) current/proposed positions; p1 the UNFLIPPED endpoint
    momentum (dq/dt = M^{-1} p evaluated before the reversibility flip);
    h the iteration's jitter; alpha the per-chain MH acceptance
    probability. Norms are taken in the sphered space z = q / sqrt(M^{-1})
    (inv_mass tracks posterior variance, so z is approximately whitened and
    the criterion treats all dimensions on one scale).

    winsorize: clip each chain's gradient contribution at this multiple of
    the cross-chain median |g_i| (0 disables). Unclipped, the estimator is
    unbounded on targets with near-linear density tails (measured on
    log_gamma: a chain drifting down the flat left tail gains squared
    distance quadratically in T at ZERO energy cost — leapfrog integrates
    linear potentials exactly, so acceptance never penalizes the runaway
    and a few tail chains drag T to the cap). Clipping at ~10x the median
    leaves light-tailed behavior untouched (the Gaussian quarter-period
    optimum is preserved by the convergence tests) while bounding any
    single chain's pull to the typical scale."""
    if inv_mass.ndim == 2:
        # dense metric: sphere with the Cholesky of the estimated
        # covariance, z = L^{-1} q (inv_mass ~ Sigma, L L^T = Sigma); the
        # velocity dz/dt = L^{-1} M^{-1} p = L^{-1} (L L^T) p = L^T p.
        # The solve/matmuls run once per warmup step — negligible next to
        # the trajectory's per-leapfrog gradients.
        from jax.scipy.linalg import solve_triangular
        L = jnp.linalg.cholesky(inv_mass.astype(q0.dtype))
        z0 = solve_triangular(L, q0.T, lower=True).T
        z1 = solve_triangular(L, q1.T, lower=True).T
        vz1 = p1 @ L
    else:
        scale = jnp.sqrt(inv_mass)        # z = q / scale
        z0 = q0 / scale
        z1 = q1 / scale
        vz1 = p1 * scale                  # dz/dt = M^{-1} p / sqrt(M^{-1})
    # A diverged trajectory overflows q1/p1 to inf/nan; its alpha is 0
    # (energy guard) but 0 * nan = nan, and one nan row would poison the
    # cross-chain mean mu1 for EVERY chain — mask diverged chains out of
    # both the means and the weighted gradient.
    finite = (jnp.all(jnp.isfinite(z1), axis=-1)
              & jnp.all(jnp.isfinite(vz1), axis=-1))
    fmask = finite.astype(z1.dtype)
    z1 = jnp.where(finite[:, None], z1, 0.0)
    vz1 = jnp.where(finite[:, None], vz1, 0.0)
    n_fin = jnp.sum(fmask)
    mu0 = jnp.mean(z0, axis=0)
    mu1_num = jnp.sum(z1, axis=0)
    if axis_name is not None:
        mu0 = lax.pmean(mu0, axis_name)
        mu1_num = lax.psum(mu1_num, axis_name)
        n_fin = lax.psum(n_fin, axis_name)
    mu1 = mu1_num / jnp.maximum(n_fin, 1.0)
    d1 = z1 - mu1
    c = jnp.sum(d1 * d1, axis=-1) - jnp.sum((z0 - mu0) ** 2, axis=-1)
    dc_dt = fmask * c * jnp.sum(d1 * vz1, axis=-1)
    # second-stage guard: a finite-but-huge q1 can overflow c to inf, and
    # inf * 0 = nan (measured on 6D rosenbrock exploration windows)
    ok = jnp.isfinite(dc_dt)
    dc_dt = jnp.where(ok, dc_dt, 0.0)
    alpha = alpha * fmask * ok
    if winsorize:
        med = jnp.median(jnp.abs(dc_dt))
        if axis_name is not None:
            # median of per-device medians — exact enough for a clip bound
            med = lax.pmean(med, axis_name)
        bound = winsorize * med
        dc_dt = jnp.clip(dc_dt, -bound, bound)
    w_num = jnp.sum(alpha * dc_dt)
    w_den = jnp.sum(alpha)
    if axis_name is not None:
        w_num = lax.psum(w_num, axis_name)
        w_den = lax.psum(w_den, axis_name)
    g = w_num / jnp.maximum(w_den, 1e-12)
    # chain rule t = h * T: d/dlogT = t * d/dt
    return g * h * trajectory_length


def num_leapfrog_steps(t, step_size, max_steps: int) -> Array:
    """Quantize trajectory time t to a leapfrog count (>=1, capped)."""
    n = jnp.ceil(t / step_size).astype(jnp.int32)
    return jnp.clip(n, 1, max_steps)


def scale_default_schedule(num_warmup: int) -> Tuple[int, list, int]:
    """Proportionally scale the Stan-style default warmup schedule
    (500 exploration + [25,50,100,200,500,1000] doubling windows + 125
    cooldown = 2500) to an arbitrary budget.

    The reference-parity windowed warmup pins its schedule to the window
    sum (build_schedule warns and ignores a mismatched num_warmup —
    reference behavior). ChEES has no parity constraint, so it honors the
    requested budget: same 20/75/5 phase proportions, same doubling window
    structure, total exactly num_warmup (small windows are dropped first
    when the budget cannot fit all six)."""
    f = num_warmup / 2500.0
    exploration = max(1, int(round(500 * f)))
    windows = [max(1, int(round(w * f)))
               for w in (25, 50, 100, 200, 500, 1000)]
    while exploration + sum(windows) + 1 > num_warmup and len(windows) > 1:
        windows.pop(0)           # drop the smallest windows first
    while exploration + sum(windows) + 1 > num_warmup and exploration > 1:
        exploration -= 1
    cooldown = max(1, num_warmup - exploration - sum(windows))
    return exploration, windows, cooldown


def _chees_one_step(log_prob_fn, value_and_grad_fn, backend, schedule_type,
                    level_steps, pos_dtype):
    """Build one_step(k, state, x, eps, gamma, steepness, inv_mass) for
    jittered sampling: x is the per-draw leapfrog count (xla backend) or
    the jitter-level branch index into `level_steps` (kernel backends)."""
    friction_schedule = None
    if schedule_type is not None:
        from mcmc_tpu.samplers.grahmc import get_friction_schedule
        friction_schedule = get_friction_schedule(schedule_type)

    if backend != "xla":
        from mcmc_tpu.ops.fused_trajectory import make_fused_grahmc_step
        fused = [make_fused_grahmc_step(log_prob_fn, value_and_grad_fn, L,
                                        friction_schedule,
                                        backend=backend)
                 for L in level_steps]

        def _branch(f):
            def call(op):
                k, s, extras = f(*op)
                return k, s, extras[0]        # keep accept, drop proposals
            return call

        branches = [_branch(f) for f in fused]

        def one_step(k, s, i, eps, gam, steep, inv_mass):
            return lax.switch(i, branches, (k, s, eps, gam, steep, inv_mass))
        return one_step

    vag = make_value_and_grad(log_prob_fn, value_and_grad_fn)

    def one_step(k, s, n, eps, gam, steep, inv_mass):
        # shared transition (samplers/trajectory.py) — one implementation
        # with the ChEES warmup and the ChEES-tuned SMC moves
        k, s, accept, _q1, _p1, _la, _div = mh_transition_dynamic(
            k, s, vag, eps, n, inv_mass,
            friction_schedule=friction_schedule, gamma_max=gam,
            steepness=steep)
        return k, s, accept
    return one_step


def _chees_scan(key, cs, idx, eps, gam, steep, inv_mass, one_step, burn_in,
                n_collect):
    """Burn-in + sampling scans over the per-draw jitter stream `idx`."""
    from mcmc_tpu.samplers.base import reset_counters

    if burn_in > 0:
        def burn_body(carry, x):
            k, s = carry
            k, s, _ = one_step(k, s, x, eps, gam, steep, inv_mass)
            return (k, s), None
        (key, cs), _ = lax.scan(burn_body, (key, cs), idx[:burn_in])
        cs = reset_counters(cs)

    def sample_body(carry, x):
        k, s = carry
        k, s, accept = one_step(k, s, x, eps, gam, steep, inv_mass)
        return (k, s), (s.position[:n_collect], s.log_prob[:n_collect])
    (key, cs), (samples, log_probs) = lax.scan(
        sample_body, (key, cs), idx[burn_in:])
    return cs, samples, log_probs


@partial(jax.jit, static_argnames=("log_prob_fn", "value_and_grad_fn",
                                   "backend", "schedule_type", "level_steps",
                                   "burn_in", "n_collect"))
def _chees_run_core(key, cs, idx, eps, gam, steep, inv_mass, *, log_prob_fn,
                    value_and_grad_fn, backend, schedule_type, level_steps,
                    burn_in, n_collect):
    """MODULE-LEVEL jitted core so repeated chees_run calls on the same
    target hit the jit cache (statics are identity-stable per target; the
    Halton-derived step counts are a TRACED operand, so a different jitter
    offset does not recompile). A per-call jax.jit(closure) with the step
    counts baked in as constants recompiled on every invocation — one full
    XLA compile per convergence checkpoint or bench rep (review finding)."""
    one_step = _chees_one_step(log_prob_fn, value_and_grad_fn, backend,
                               schedule_type, level_steps, cs.position.dtype)
    return _chees_scan(key, cs, idx, eps, gam, steep, inv_mass, one_step,
                       burn_in, n_collect)


def chees_run(
    key,
    log_prob_fn,
    init_position: Array,
    step_size: float,
    trajectory_length: float,
    num_samples: int,
    burn_in: int = 0,
    inv_mass_matrix: Optional[Array] = None,
    value_and_grad_fn=None,
    collect_chains: Optional[int] = None,
    backend: str = "auto",
    max_steps: int = DEFAULT_MAX_STEPS,
    jitter_levels: int = 4,
    schedule_type: Optional[str] = None,
    gamma: float = 0.0,
    steepness: float = 1.0,
    halton_offset: int = 8192,
    mesh=None,
):
    """Jittered-trajectory sampling at the ChEES-tuned operating point.

    Each draw integrates t_i = h_i * trajectory_length (h_i quasirandom,
    shared by all chains) — the sampling-phase counterpart of the warmup's
    jitter. Running WITH jitter is the point of the tuned T: a fixed L on a
    near-Gaussian target sits at the mercy of leapfrog resonance (eps*L
    landing on a multiple of a period makes proposals return to their
    start), which jitter averages away.

    backend:
      'xla'    — continuous jitter; each draw's leapfrog count is a traced
                 while_loop trip count (integrate_trajectory_dynamic).
      'pallas' — the fused trajectory kernel. It has a static trip count,
                 so the jitter is QUANTIZED: h is binned into
                 `jitter_levels` levels, one kernel is compiled per
                 distinct level length, and each draw `lax.switch`es to its
                 level's kernel. <=4 kernels amortize over the run.
      'interpret' — the 'pallas' path under the Pallas interpreter.
      'auto'   — ops/padded_targets.resolve_backend.

    mesh: shard chains over the mesh's chain axis and run the whole scan
    shard_mapped (the Pallas kernels are opaque to GSPMD, so explicit
    shard_map is the only multi-chip route; the XLA while_loop path rides
    along for free since its trip counts are chain-independent). The
    per-draw jitter stream is replicated — every device integrates the
    same lengths, so there is no cross-device load imbalance. With a mesh,
    `collect_chains` is PER DEVICE (default: all local chains).

    Returns the uniform RunResult; info carries total_leapfrogs (the REAL
    gradient count — jittered draws are cheaper than num_samples * L_max)
    and the realized per-draw leapfrog counts.
    """
    from mcmc_tpu.samplers.base import finalize_run
    if trajectory_length <= 0 or step_size <= 0:
        raise ValueError("step_size and trajectory_length must be positive")

    cs = init_chain_state(init_position, log_prob_fn, value_and_grad_fn,
                          needs_grad=True)
    n_chains, n_dim = cs.position.shape
    pos_dtype = cs.position.dtype
    if inv_mass_matrix is None:
        inv_mass_matrix = jnp.ones(n_dim, dtype=pos_dtype)
    inv_mass = jnp.asarray(inv_mass_matrix, pos_dtype)
    if mesh is not None:
        n_dev = mesh.devices.size
        if n_chains % n_dev:
            raise ValueError(f"n_chains {n_chains} not divisible by mesh "
                             f"size {n_dev}")
        n_collect = (n_chains // n_dev if collect_chains is None
                     else collect_chains)
    else:
        n_collect = n_chains if collect_chains is None else collect_chains

    from mcmc_tpu.ops.padded_targets import resolve_backend
    backend = resolve_backend(backend, value_and_grad_fn)
    # dense metrics run in-kernel on the kernel backends (the fused
    # trajectory kernel takes the (D, D) M^{-1} as an operand)
    if backend != "xla" and jnp.ndim(inv_mass) == 2:
        # factor ONCE, outside the sampling scan: XLA cannot hoist a
        # Cholesky out of the per-draw lax.switch branch computations
        # (see PreparedDenseMetric)
        from mcmc_tpu.ops.fused_trajectory import prepare_dense_metric
        inv_mass = prepare_dense_metric(inv_mass, n_dim)

    total = burn_in + num_samples
    h = halton_sequence(total, halton_offset)

    if backend != "xla":
        levels = max(1, int(jitter_levels))
        level_L = [int(np.clip(round((k + 0.5) / levels
                                     * trajectory_length / step_size),
                               1, max_steps)) for k in range(levels)]
        Ls = sorted(set(level_L))
        branch_of_level = [Ls.index(L) for L in level_L]
        idx = jnp.asarray(
            [branch_of_level[min(levels - 1, int(x * levels))] for x in h],
            jnp.int32)
        ns = np.asarray([Ls[i] for i in np.asarray(idx)], np.int64)
        level_steps = tuple(Ls)
    else:
        ns_f = np.ceil(h * trajectory_length / step_size)
        ns = np.clip(ns_f, 1, max_steps).astype(np.int64)
        idx = jnp.asarray(ns, jnp.int32)   # xs: the leapfrog counts
        level_steps = None

    eps = jnp.asarray(step_size, pos_dtype)
    gam = jnp.asarray(gamma, pos_dtype)
    steep = jnp.asarray(steepness, pos_dtype)

    if mesh is None:
        cs, samples, log_probs = _chees_run_core(
            key, cs, idx, eps, gam, steep, inv_mass,
            log_prob_fn=log_prob_fn, value_and_grad_fn=value_and_grad_fn,
            backend=backend, schedule_type=schedule_type,
            level_steps=level_steps, burn_in=burn_in, n_collect=n_collect)
    else:
        from jax.sharding import PartitionSpec as P
        from mcmc_tpu.parallel import CHAIN_AXIS, shard_chains, shard_map_fn

        def lead(leaf):
            nd = jnp.ndim(leaf)
            return P() if nd == 0 else P(CHAIN_AXIS, *([None] * (nd - 1)))

        cs = shard_chains(cs, mesh)
        cs_specs = jax.tree.map(lead, cs)
        one_step = _chees_one_step(log_prob_fn, value_and_grad_fn, backend,
                                   schedule_type, level_steps, pos_dtype)

        def inner(key, cs):
            key = random.fold_in(key, lax.axis_index(CHAIN_AXIS))
            return _chees_scan(key, cs, idx, eps, gam, steep, inv_mass,
                               one_step, burn_in, n_collect)

        cs, samples, log_probs = jax.jit(shard_map_fn(
            inner, mesh,
            in_specs=(P(), cs_specs),
            out_specs=(cs_specs, P(None, CHAIN_AXIS, None),
                       P(None, CHAIN_AXIS))))(key, cs)
    sample_ns = ns[burn_in:]
    extra = {
        "total_leapfrogs": int(sample_ns.sum()),
        "mean_num_steps": float(sample_ns.mean()),
        "num_steps_per_draw": np.asarray(sample_ns, np.int32),
        "trajectory_length": float(trajectory_length),
        "jitter_backend": backend,
    }
    if backend != "xla":
        extra["jitter_level_steps"] = Ls
    return finalize_run(cs, samples, log_probs, num_samples, extra)


def run_chees_warmup(
    sampler: str,
    target_log_prob,
    target_grad_log_prob,            # API parity with run_adaptive_warmup
    initial_position: Array,
    key: Array,
    num_warmup: int = 1000,
    target_accept: float = 0.651,
    schedule_type: Optional[str] = None,
    update_freq: int = 100,
    learn_mass_matrix: bool = True,
    value_and_grad_fn=None,
    verbose: bool = False,
    max_steps: int = DEFAULT_MAX_STEPS,
    adam_lr: float = CHEES_ADAM_LR,
    initial_trajectory_length: Optional[float] = None,
    gamma: float = 1.0,
    steepness: Optional[float] = None,
    mesh=None,
    gamma_tuner: str = "grid",
    **kwargs,
) -> Tuple[float, Optional[Array], Array, Dict]:
    """ChEES warmup: jointly adapt step size (dual averaging), diagonal mass
    matrix (Welford windows) and trajectory length (ChEES/Adam).

    Same window schedule, DA core, shrinkage and return contract as
    `run_adaptive_warmup`; the extra product is the tuned trajectory:
    info["trajectory_length"] (continuous T) and info["num_steps"] (the
    equivalent fixed leapfrog count round(T / step_size), what the sampling
    phase should use as L — with jittered sampling, as the MAX length).

    sampler: 'hmc', or 'grahmc'/'rahmc'. target_accept defaults to the
    jittered-HMC optimum 0.651.

    gamma_tuner (GRAHMC only): 'grid' holds friction at `gamma` during
    adaptation and runs the separate sequential ESJD grid afterwards
    (reference-contract two-phase pipeline); 'joint' adapts log gamma by
    two-sided SPSA on the acceptance-weighted sphered ESJD INSIDE the same
    warmup (one phase produces eps, M, T, gamma — round 4, VERDICT r3 #8),
    falling back to the grid only if the iterate ends pinned at a clip
    bound (degenerate signal). 'joint' requires a diagonal metric (the
    sphered ESJD divides by inv_mass per coordinate).
    """
    if sampler not in ("hmc", "grahmc", "rahmc"):
        raise ValueError(f"ChEES adaptation supports hmc/grahmc, got {sampler}")
    if gamma_tuner not in ("grid", "joint"):
        raise ValueError(f"unknown gamma_tuner {gamma_tuner!r}")
    joint_gamma = gamma_tuner == "joint" and sampler in ("grahmc", "rahmc")
    if joint_gamma and learn_mass_matrix == "dense":
        raise ValueError("gamma_tuner='joint' needs a diagonal metric "
                         "(sphered ESJD); use gamma_tuner='grid' with "
                         "learn_mass_matrix='dense'")
    # 'dense' learns a full covariance metric: pooled second moments
    # (replicated under a mesh via per-step psums, exactly like
    # run_adaptive_warmup), dense momentum draws/kinetic in the probes,
    # and the ChEES criterion spheres with the Cholesky of the estimate.
    dense_mass = learn_mass_matrix == "dense"
    n_chains, n_dim = initial_position.shape
    pos_dtype = initial_position.dtype

    friction_schedule = None
    if sampler in ("grahmc", "rahmc"):
        from mcmc_tpu.samplers.grahmc import (
            get_friction_schedule, default_steepness)
        friction_schedule = get_friction_schedule(schedule_type or "constant")
        if steepness is None:
            steepness = default_steepness(schedule_type or "constant")

    vag = make_value_and_grad(target_log_prob, value_and_grad_fn)
    axis_name = None
    if mesh is not None:
        from mcmc_tpu.parallel import CHAIN_AXIS
        axis_name = CHAIN_AXIS
        if n_chains % mesh.devices.size:
            raise ValueError(f"n_chains {n_chains} not divisible by mesh "
                             f"size {mesh.devices.size}")

    def _pmean(x):
        return x if axis_name is None else lax.pmean(x, axis_name)

    initial_step = 0.5 / float(np.sqrt(n_dim))
    if initial_trajectory_length is None:
        # one leapfrog step to start; Adam on log T grows it geometrically
        initial_trajectory_length = initial_step

    def step_body(carry, xs):
        key, cs, da, ch, wf, gs, accumulate = carry
        h, live = xs
        eps = da_step_size(da).astype(pos_dtype)
        e_dtype = cs.log_prob.dtype
        T = jnp.clip(jnp.exp(ch.log_t).astype(pos_dtype),
                     eps, max_steps * eps)
        n = num_leapfrog_steps(h.astype(pos_dtype) * T, eps, max_steps)

        inv_mass = wf.inv_mass
        q0 = cs.position
        if joint_gamma:
            # two-sided probe: live steps alternate +-delta around the
            # current iterate (parity of the LIVE step count, so padding
            # steps never break the alternation)
            probe_plus = ((gs.n_p + gs.n_m) % 2.0) < 0.5
            sign = jnp.where(probe_plus, 1.0, -1.0)
            gamma_t = jnp.exp(gs.log_gamma
                              + sign * GAMMA_SPSA_DELTA).astype(pos_dtype)
        else:
            gamma_t = gamma
        # shared transition (samplers/trajectory.py): same RNG order
        # (k_mom, k_acc), same guard/divergence/accept contract as the
        # ChEES sampler and the ChEES-tuned SMC moves
        key, cs, _accept, q1, p1, log_alpha, _div = mh_transition_dynamic(
            key, cs, vag, eps, n, inv_mass,
            friction_schedule=friction_schedule, gamma_max=gamma_t,
            steepness=steepness)
        alpha = jnp.exp(log_alpha)
        if joint_gamma:
            # acceptance-weighted SPHERED expected squared jump distance:
            # the per-coordinate variance estimate (inv_mass) spheres the
            # displacement so the signal is preconditioning-invariant
            d = (q1 - q0).astype(jnp.float32)
            esjd = _pmean(jnp.mean(
                alpha.astype(jnp.float32)
                * jnp.sum(d * d / wf.inv_mass.astype(jnp.float32), axis=-1)))
            live_f = live.astype(jnp.float32)
            gs = gs._replace(
                sum_p=gs.sum_p + jnp.where(probe_plus, esjd, 0.0) * live_f,
                n_p=gs.n_p + jnp.where(probe_plus, live_f, 0.0),
                sum_m=gs.sum_m + jnp.where(probe_plus, 0.0, esjd) * live_f,
                n_m=gs.n_m + jnp.where(probe_plus, 0.0, live_f))

        g = chees_log_t_grad(q0, q1, p1, h.astype(pos_dtype), T,
                             alpha.astype(pos_dtype), inv_mass,
                             axis_name=axis_name)
        # `live` masks the uniform-shape batch padding: a dead step is
        # still a valid (1-leapfrog, h=0) MH transition for the chains,
        # but it must not advance the adaptation (ChEES/Adam count,
        # Welford, the batch acceptance statistic)
        ch_new = chees_update(ch, g, lr=adam_lr)
        ch = jax.tree.map(lambda a, b: jnp.where(live, a, b), ch_new, ch)
        if dense_mass:
            # where-select instead of lax.cond so the psum (a collective)
            # executes unconditionally/uniformly on every device
            w_new = dense_moment_update(wf.state, cs.position)
            if axis_name is not None:
                w_new = psum_increment(w_new, wf.state, axis_name)
            upd = jnp.logical_and(accumulate, live)
            wf = wf._replace(state=jax.tree.map(
                lambda a, b: jnp.where(upd, a, b), w_new, wf.state))
        else:
            wf = wf._replace(state=lax.cond(
                jnp.logical_and(accumulate, live),
                lambda s: welford_update(s, cs.position),
                lambda s: s, wf.state))
        accept_stat = _pmean(jnp.mean(alpha))
        return ((key, cs, da, ch, wf, gs, accumulate),
                (accept_stat, n, ch.log_t))

    class _WF(NamedTuple):
        # mass matrix + Welford bundled so the scan carry stays one pytree
        inv_mass: Array
        state: object

    def _batch_core(key, cs, da, ch, wf, gs, accumulate, jitter, mask):
        """One DA batch at the UNIFORM shape (update_freq,): every window
        is stepped in fixed-width batches (short windows / remainders are
        padded with masked steps), so the whole warmup compiles exactly ONE
        program per process instead of one per distinct window geometry,
        each of which would pay a full XLA compile."""
        (key, cs, da, ch, wf, gs, _), (alphas, ns, log_ts) = lax.scan(
            step_body, (key, cs, da, ch, wf, gs, accumulate), (jitter, mask))
        w = mask.astype(alphas.dtype)
        wsum = jnp.maximum(jnp.sum(w), 1.0)
        acc_mean = jnp.sum(alphas * w) / wsum
        da = da_update(da, acc_mean, target_accept)
        if joint_gamma:
            # one RM step on log gamma per batch (probe sums are pmean'd
            # per step, so the iterate is identical on every device)
            gs = gamma_spsa_batch_update(gs)
        trace = (acc_mean,
                 jnp.sum(log_ts * w.astype(log_ts.dtype)) / wsum,
                 jnp.sum(ns.astype(pos_dtype) * w.astype(pos_dtype)) / wsum,
                 gs.log_gamma)
        return key, cs, da, ch, wf, gs, trace

    def _wf_specs(wf):
        """_WF partition specs: inv_mass is the metric and REPLICATED (not
        per-chain data); Welford mean/m2 shard their chain axis, the count
        scalar replicates. The pooled DenseMomentState has no chain axis —
        its global sums stay replicated (per-step psum'd in step_body)."""
        from jax.sharding import PartitionSpec as P
        from mcmc_tpu.parallel import CHAIN_AXIS

        if dense_mass:
            return _WF(inv_mass=P(),
                       state=jax.tree.map(lambda _: P(), wf.state))

        def lead(leaf):
            nd = jnp.ndim(leaf)
            return P() if nd == 0 else P(CHAIN_AXIS, *([None] * (nd - 1)))
        return _WF(inv_mass=P(), state=jax.tree.map(lead, wf.state))

    if mesh is None:
        run_batch = jax.jit(_batch_core)
    else:
        from jax.sharding import PartitionSpec as P
        from mcmc_tpu.parallel import CHAIN_AXIS, shard_map_fn

        @jax.jit
        def run_batch(keys, cs, da, ch, wf, gs, accumulate, jitter, mask):
            def lead(leaf):
                nd = jnp.ndim(leaf)
                return (P() if nd == 0
                        else P(CHAIN_AXIS, *([None] * (nd - 1))))
            kspec = P(CHAIN_AXIS, None)
            cs_specs = jax.tree.map(lead, cs)
            rep = lambda tree: jax.tree.map(lambda _: P(), tree)
            common = (kspec, cs_specs, rep(da), rep(ch), _wf_specs(wf),
                      rep(gs))
            in_specs = common + (P(), P(), P())
            # trace stats are psum/pmean'd globally inside step_body, and
            # the DA/ChEES/gamma states see only those global statistics —
            # all stay bit-identical (replicated) on every device
            out_specs = common + (rep((0.0, 0.0, 0.0, 0.0)),)

            def inner(keys, cs, da, ch, wf, gs, accumulate, jitter, mask):
                key, cs, da, ch, wf, gs, trace = _batch_core(
                    keys[0], cs, da, ch, wf, gs, accumulate, jitter, mask)
                return keys.at[0].set(key), cs, da, ch, wf, gs, trace

            return shard_map_fn(inner, mesh, in_specs=in_specs,
                                out_specs=out_specs)(
                keys, cs, da, ch, wf, gs, accumulate, jitter, mask)

    # --- initial state ----------------------------------------------------
    da = da_init(initial_step)
    ch = chees_init(initial_trajectory_length,
                    dtype=jnp.asarray(initial_step).dtype)
    cs = init_chain_state(initial_position, target_log_prob,
                          value_and_grad_fn, needs_grad=True)
    # friction SPSA state (constant placeholder when not joint-tuning, so
    # the carry structure — and the single compiled batch program — is the
    # same in both modes)
    gs = gamma_spsa_init(gamma if joint_gamma else 1.0, dtype=jnp.float32)
    if dense_mass:
        # identity as a dense matrix + a pooled accumulator from the start
        # so the carry shapes stay uniform for the whole warmup (same
        # compile-shape discipline as run_adaptive_warmup's dense path)
        wf = _WF(inv_mass=jnp.eye(n_dim, dtype=pos_dtype),
                 state=dense_moment_init(jnp.zeros(n_dim, dtype=pos_dtype)))
    else:
        wf = _WF(inv_mass=jnp.ones(n_dim, dtype=pos_dtype),
                 state=welford_init((n_chains, n_dim)))
    if mesh is not None:
        # distinct per-device key streams, carried sharded over the mesh
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P
        from mcmc_tpu.parallel import CHAIN_AXIS, shard_chains, replicate
        key = jax.device_put(
            random.split(key, mesh.devices.size),
            NamedSharding(mesh, P(CHAIN_AXIS, None)))
        cs = shard_chains(cs, mesh)
        wf = _WF(inv_mass=replicate(wf.inv_mass, mesh),
                 state=(jax.tree.map(lambda x: replicate(x, mesh), wf.state)
                        if dense_mass else shard_chains(wf.state, mesh)))

    if ("exploration_steps" in kwargs or "adaptation_windows" in kwargs
            or "cooldown_steps" in kwargs):
        exploration_steps = kwargs.get("exploration_steps", 500)
        adaptation_windows = kwargs.get("adaptation_windows")
        cooldown_steps = kwargs.get("cooldown_steps", 125)
    else:
        # honor num_warmup exactly (see scale_default_schedule; the
        # reference-parity grid warmup instead pins 2500 and warns)
        exploration_steps, adaptation_windows, cooldown_steps = (
            scale_default_schedule(num_warmup))
    schedule = build_schedule(
        num_warmup,
        exploration_steps=exploration_steps,
        adaptation_windows=adaptation_windows,
        cooldown_steps=cooldown_steps)
    if verbose:
        print(f"ChEES adaptation schedule "
              f"({sum(e - s for s, e, _ in schedule)} steps), "
              f"max_steps={max_steps}, adam_lr={adam_lr}")

    halton_offset = 0
    accept_trace, log_t_trace, mean_n_trace = [], [], []
    log_gamma_trace = []
    final_phase_log_ts, final_phase_weights = [], []
    final_phase_log_gammas = []
    B = max(1, int(update_freq))
    for start_idx, end_idx, phase in schedule:
        window_len = end_idx - start_idx
        accumulate = phase == "adaptation" and bool(learn_mass_matrix)
        if accumulate:
            if dense_mass:
                # re-center the pooled accumulator at the current chain
                # mean (same as run_adaptive_warmup's dense window re-init);
                # on a sharded position GSPMD computes the global mean and
                # the fresh state replicates
                fresh = dense_moment_init(jnp.mean(cs.position, axis=0))
                if mesh is not None:
                    from mcmc_tpu.parallel import replicate
                    fresh = jax.tree.map(lambda x: replicate(x, mesh), fresh)
            else:
                fresh = welford_init((n_chains, n_dim))
                if mesh is not None:
                    from mcmc_tpu.parallel import shard_chains
                    fresh = shard_chains(fresh, mesh)
            wf = wf._replace(state=fresh)
        for n_real, live in fixed_width_batches(window_len, B):
            row = np.zeros(B, dtype=np.float64)
            row[:n_real] = halton_sequence(n_real, halton_offset)
            halton_offset += n_real
            key, cs, da, ch, wf, gs, (acc, log_t, mean_n, log_g) = run_batch(
                key, cs, da, ch, wf, gs, jnp.asarray(accumulate),
                jnp.asarray(row, pos_dtype), live)
            # device scalars, converted after the loop (a float() here
            # would block on a device->host round trip per batch)
            accept_trace.append(acc)
            log_t_trace.append(log_t)
            mean_n_trace.append(mean_n)
            log_gamma_trace.append(log_g)
            if phase == "cooldown":
                final_phase_log_ts.append(log_t)
                final_phase_weights.append(n_real)
                final_phase_log_gammas.append(log_g)

        if accumulate:
            if dense_mass:
                # per-step count (pooled count / n_chains): same shrinkage
                # convention as run_adaptive_warmup so the two warmups
                # produce identical metrics from identical data
                inv_mass = shrink_covariance(
                    dense_covariance(wf.state),
                    wf.state.count / n_chains).astype(pos_dtype)
            else:
                variance = chain_averaged_variance(wf.state)
                inv_mass = shrink_variance(
                    variance, wf.state.count).astype(pos_dtype)
            wf = wf._replace(inv_mass=inv_mass)
            da = da_reset(da)
            if verbose:
                print(f"  window [{start_idx}-{end_idx}]: "
                      f"T={float(jnp.exp(ch.log_t)):.4f} "
                      f"mass range [{float(jnp.min(inv_mass)):.4f}, "
                      f"{float(jnp.max(inv_mass)):.4f}]")

    accept_trace = [float(a) for a in accept_trace]
    log_t_trace = [float(t) for t in log_t_trace]
    mean_n_trace = [float(x) for x in mean_n_trace]
    step_size = float(da_final_step_size(da))
    # Polyak-style iterate averaging: the final Adam iterate is a noisy
    # sample of the stochastic ascent; average log T over the cooldown
    # phase (where step size and mass matrix are frozen) instead. Batch
    # means are weighted by their LIVE step counts so a short remainder
    # batch does not get a full batch's weight.
    log_t_final = (float(np.average([float(t) for t in final_phase_log_ts],
                                    weights=final_phase_weights))
                   if final_phase_log_ts else float(ch.log_t))
    # Cap detection BEFORE the clip (and before any phase-3 step retune,
    # which would otherwise mask a runaway by shifting round(T/step) back
    # under max_steps — and, conversely, flag a legitimate T that merely
    # rounds to max_steps): the criterion ran away iff the raw averaged
    # iterate sits at/above the cap.
    max_steps_cap_hit = bool(np.exp(log_t_final) >= max_steps * step_size)
    trajectory_length = float(np.clip(np.exp(log_t_final),
                                      step_size, max_steps * step_size))
    num_steps = int(max(1, round(trajectory_length / step_size)))
    inv_mass = wf.inv_mass if learn_mass_matrix else None
    position = cs.position

    # GRAHMC friction product. Joint mode: the SPSA iterate was adapted
    # inside the warmup — Polyak-average log gamma over the cooldown
    # batches (same convention as log T) and skip the separate grid phase
    # entirely, UNLESS the iterate ended pinned at a clip bound (the ESJD
    # signal was degenerate — e.g. acceptance collapsed): then fall back
    # to the sequential grid exactly as the grid mode would run.
    gamma_fallback_to_grid = False
    run_grid_phase = (friction_schedule is not None
                      and kwargs.get("tune_gamma", True))
    tuned_gamma = gamma if friction_schedule is not None else None
    if joint_gamma and kwargs.get("tune_gamma", True):
        lg_final = (float(np.average(
            [float(g) for g in final_phase_log_gammas],
            weights=final_phase_weights))
            if final_phase_log_gammas else float(gs.log_gamma))
        at_bound = (lg_final <= np.log(GAMMA_MIN) * 0.99 + 0.01
                    or lg_final >= np.log(GAMMA_MAX) * 0.99)
        if at_bound:
            gamma_fallback_to_grid = True
        else:
            tuned_gamma = float(np.exp(lg_final))
            run_grid_phase = False
    if run_grid_phase:
        from mcmc_tpu.tuning.sequential import sequential_tune_grahmc
        # same backend resolution as run_adaptive_warmup (dense metrics
        # included — the fused kernel takes them as an operand)
        from mcmc_tpu.ops.padded_targets import resolve_backend
        seq_backend = resolve_backend("auto", value_and_grad_fn)
        step_size, tuned_gamma, steepness, _hist = sequential_tune_grahmc(
            key=random.fold_in(key[0] if mesh is not None else key, 999),
            log_prob_fn=target_log_prob,
            grad_log_prob_fn=target_grad_log_prob,
            init_position=position,
            num_steps=num_steps,
            schedule_type=schedule_type or "constant",
            target_accept=target_accept,
            inv_mass_matrix=inv_mass,
            init_step_size=step_size,
            gamma_coarse_values=kwargs.get("gamma_coarse_values"),
            gamma_samples_per_eval=kwargs.get("gamma_samples_per_eval", 150),
            value_and_grad_fn=value_and_grad_fn,
            steepness=steepness,
            verbose=verbose,
            backend=seq_backend,
            # under a mesh the DA/ESJD probes run shard_mapped per device
            # with pmean'd feedback (same contract as the windowed warmup)
            mesh=mesh,
        )
        step_size = float(step_size)
        num_steps = int(max(1, round(trajectory_length / step_size)))
        if num_steps > max_steps:
            # the retuned (smaller) step pushed the equivalent leapfrog
            # count past the cap: sampling would silently truncate every
            # long-jitter draw (num_leapfrog_steps clips at max_steps) —
            # report it so callers fall back to the grid (review finding)
            max_steps_cap_hit = True

    info = {
        "trajectory_length": trajectory_length,
        "num_steps": num_steps,
        "step_size": step_size,
        "mass_matrix_learned": learn_mass_matrix,
        "accept_history": accept_trace,
        "log_t_history": log_t_trace,
        "mean_leapfrogs_history": mean_n_trace,
        "halton_offset": halton_offset,
        "max_steps_cap_hit": max_steps_cap_hit,
        "target_accept": target_accept,
    }
    if friction_schedule is not None:
        info["gamma"] = float(tuned_gamma)
        info["steepness"] = float(steepness)
        info["gamma_tuner"] = (
            "joint" if joint_gamma and not gamma_fallback_to_grid
            else "grid")
        if joint_gamma:
            info["log_gamma_history"] = [float(g) for g in log_gamma_trace]
            info["gamma_fallback_to_grid"] = gamma_fallback_to_grid
    if verbose:
        print(f"ChEES complete: T={trajectory_length:.4f} "
              f"step={step_size:.5f} -> L={num_steps}")
    return step_size, inv_mass, position, info
