"""Multi-device sampling: shard_map over the chain mesh axis.

GSPMD partitions the XLA samplers automatically (chains are communication-
free), but a pallas_call is opaque to the partitioner — the fused trajectory
kernel must be explicitly shard_mapped: each device runs it on its local
chain shard with a per-device RNG stream (fold_in on the mesh axis index).
The only collectives are the final psums for the divergence/leapfrog totals;
the sampling loops stay collective-free.

Wrappers: `grahmc_run_sharded` (fused trajectory kernel),
`tempered_run_sharded` (replica exchange, device-local swaps),
`nuts_persistent_run_sharded` (the persistent-NUTS XLA machine per device)
and `smc_run_sharded` (psum'd weight reductions, island-local resampling).
Tested on a virtual CPU mesh; `chip_smoke.py --multi` runs the parity
checks on four GPUs.
"""

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax, random
from jax.sharding import PartitionSpec as P

from mcmc_tpu.parallel import CHAIN_AXIS, shard_chains, shard_map_fn
from mcmc_tpu.samplers.base import RunResult, init_chain_state, reset_counters
from mcmc_tpu.samplers.grahmc import constant_schedule
from mcmc_tpu.samplers.nuts_persistent import _count_dtype


def grahmc_run_sharded(
    key,
    target,
    init_position,
    mesh,
    step_size,
    num_steps: int,
    gamma,
    steepness,
    num_samples: int,
    burn_in: int = 0,
    inv_mass_matrix=None,
    friction_schedule: Optional[Callable] = None,
    collect_chains_per_device: int = 8,
    backend: str = "pallas",
) -> RunResult:
    """Run fused-kernel GRAHMC with chains sharded over `mesh`'s chain axis.

    init_position: (n_chains, dim) with n_chains divisible by the mesh size.
    Collects a `collect_chains_per_device` history prefix per device
    (concatenated across devices in the output). backend='interpret' runs
    the kernel under the Pallas interpreter.
    """
    from mcmc_tpu.ops.fused_trajectory import make_fused_grahmc_step

    if friction_schedule is None:
        friction_schedule = constant_schedule

    n_chains, dim = init_position.shape
    n_dev = mesh.devices.size
    if n_chains % n_dev:
        raise ValueError(f"n_chains {n_chains} not divisible by mesh size {n_dev}")
    if inv_mass_matrix is None:
        inv_mass_matrix = jnp.ones(dim, jnp.float32)
    inv_mass_matrix = jnp.asarray(inv_mass_matrix, jnp.float32)
    if jnp.ndim(inv_mass_matrix) == 2:
        # factor the dense metric once, replicated to every device (the
        # P() in_spec below is a pytree-prefix spec, covering both leaves)
        from mcmc_tpu.ops.fused_trajectory import prepare_dense_metric
        inv_mass_matrix = prepare_dense_metric(inv_mass_matrix, dim)

    fused = make_fused_grahmc_step(
        target.log_prob_fn, target.value_and_grad_fn, num_steps,
        friction_schedule, backend=backend)

    init_position = shard_chains(jnp.asarray(init_position, jnp.float32), mesh)
    scalars = (jnp.asarray(step_size, jnp.float32),
               jnp.asarray(gamma, jnp.float32),
               jnp.asarray(steepness, jnp.float32))

    @partial(
        shard_map_fn, mesh=mesh,
        in_specs=(P(), P(CHAIN_AXIS, None), P(), P(), P(), P()),
        out_specs=(P(None, CHAIN_AXIS, None),   # samples prefix
                   P(None, CHAIN_AXIS),          # log_probs prefix
                   P(CHAIN_AXIS),                # accept counts
                   P(CHAIN_AXIS),                # divergence counts
                   P(CHAIN_AXIS, None),          # final positions
                   P(CHAIN_AXIS),                # final log-probs
                   P(CHAIN_AXIS, None),          # final grads
                   P()))                         # global divergence total
    def run_shard(key, local_pos, eps, gam, steep, inv_mass):
        key = random.fold_in(key, lax.axis_index(CHAIN_AXIS))
        state = init_chain_state(local_pos, target.log_prob_fn,
                                 target.value_and_grad_fn)

        def step(carry, _):
            k, s = carry
            k, s, _ = fused(k, s, eps, gam, steep, inv_mass)
            return (k, s), None

        if burn_in > 0:
            (key, state), _ = lax.scan(step, (key, state), length=burn_in)
            state = reset_counters(state)

        def sample(carry, _):
            k, s = carry
            k, s, _ = fused(k, s, eps, gam, steep, inv_mass)
            return (k, s), (s.position[:collect_chains_per_device],
                            s.log_prob[:collect_chains_per_device])

        (key, state), (samples, lps) = lax.scan(sample, (key, state),
                                                length=num_samples)
        total_div = lax.psum(jnp.sum(state.divergence_count), CHAIN_AXIS)
        return (samples, lps, state.accept_count, state.divergence_count,
                state.position, state.log_prob, state.grad_log_prob, total_div)

    (samples, lps, acc_counts, div_counts, final_pos, final_lp, final_grad,
     total_div) = run_shard(key, init_position, *scalars, inv_mass_matrix)

    return _assemble_result(samples, lps, acc_counts, div_counts, final_pos,
                            final_lp, final_grad, total_div, num_samples,
                            n_chains, n_dev)


def _assemble_result(samples, lps, acc_counts, div_counts, final_pos,
                     final_lp, final_grad, total_div, num_samples, n_chains,
                     n_dev) -> RunResult:

    accept_rate = acc_counts.astype(jnp.float32) / num_samples
    info = {
        "divergence_count": div_counts,
        "total_divergences": total_div,
        "divergence_rate": total_div.astype(jnp.float32) / (num_samples * n_chains),
        "final_positions": final_pos,
        "n_devices": n_dev,
    }
    from mcmc_tpu.samplers.base import ChainState
    final_state = ChainState(
        position=final_pos, log_prob=final_lp, grad_log_prob=final_grad,
        accept_count=acc_counts, divergence_count=div_counts)
    return RunResult(samples, lps, accept_rate, final_state, info)


def tempered_run_sharded(
    key,
    target,
    init_position,
    mesh,
    step_size,
    num_steps: int,
    num_samples: int,
    n_temps: int = 6,
    beta_min: float = 0.05,
    swap_interval: int = 1,
    inv_mass_matrix=None,
    gamma=0.0,
    steepness=1.0,
    friction_schedule: Optional[Callable] = None,
    backend: str = "auto",
    replica_position=None,
    betas=None,
) -> RunResult:
    """Parallel tempering with chains sharded over `mesh`'s chain axis.

    Replica exchange acts only along the temperature axis (samplers/
    tempered.py), so sharding the CHAIN axis keeps every swap device-local:
    each device runs the full K-rung ladder on its local chain shard
    (per-device fold_in RNG) and the sampling loop stays collective-free —
    the only collectives are the final psums for the divergence total and
    the cross-device swap/replica acceptance means.

    replica_position: a previous call's info["replica_final_positions"]
    ((K * n_chains, D), device-major blocks of replica-major local rows) to
    continue the ladder across convergence-checkpoint batches. Round-trips
    exactly through this function's own output sharding.

    betas: explicit descending (K,) ladder (e.g. from tuning/ladder.py's
    adaptive tuner) overriding the geometric default; replicated across
    the mesh and traced, so re-tuned ladders reuse the compiled program.
    """
    from mcmc_tpu.samplers.base import ChainState
    from mcmc_tpu.samplers.tempered import (_validate_betas,
                                            geometric_ladder, tempered_run)

    if betas is None:
        betas = geometric_ladder(n_temps, beta_min)
    elif not isinstance(betas, jax.core.Tracer):
        _validate_betas(betas)   # inside run_shard betas is always traced
    betas = jnp.asarray(betas, jnp.float32)
    n_temps = int(betas.shape[0])

    n_chains, dim = init_position.shape
    n_dev = mesh.devices.size
    if n_chains % n_dev:
        raise ValueError(
            f"n_chains {n_chains} not divisible by mesh size {n_dev}")
    if inv_mass_matrix is None:
        inv_mass_matrix = jnp.ones(dim, jnp.float32)
    inv_mass_matrix = jnp.asarray(inv_mass_matrix, jnp.float32)

    init_position = shard_chains(jnp.asarray(init_position, jnp.float32),
                                 mesh)
    have_replica = replica_position is not None
    if have_replica:
        replica_position = shard_chains(
            jnp.asarray(replica_position, jnp.float32), mesh)
        replica_spec = P(CHAIN_AXIS, None)
    else:
        # run_shard closes over `have_replica`, so cold-start and
        # continuation trace different programs either way — a full-size
        # dummy would buy no signature reuse, only a (K*C, D) allocation.
        # A (1, 1) replicated placeholder keeps the arity fixed for free.
        replica_position = jnp.zeros((1, 1), jnp.float32)
        replica_spec = P(None, None)

    sharded = P(CHAIN_AXIS)
    out_specs = RunResult(
        samples=P(None, CHAIN_AXIS, None),
        log_probs=P(None, CHAIN_AXIS),
        accept_rate=sharded,
        final_state=ChainState(
            position=P(CHAIN_AXIS, None), log_prob=sharded,
            grad_log_prob=P(CHAIN_AXIS, None), accept_count=sharded,
            divergence_count=sharded),
        info={
            "divergence_count": sharded,
            "total_divergences": P(),
            "divergence_rate": P(),
            "final_positions": P(CHAIN_AXIS, None),
            "replica_final_positions": P(CHAIN_AXIS, None),
            "swap_accept_rate": P(),
            "swap_attempts": P(),
            "betas": P(),
            "replica_step_sizes": P(),
            "n_temps": P(),
            "replica_accept_rate": P(),
            "n_devices": P(),
        })

    @partial(shard_map_fn, mesh=mesh,
             in_specs=(P(), P(CHAIN_AXIS, None), replica_spec,
                       P(), P(), P(), P(), P()),
             out_specs=out_specs)
    def run_shard(key, local_pos, local_replica, eps, gam, steep, inv_mass,
                  local_betas):
        key = random.fold_in(key, lax.axis_index(CHAIN_AXIS))
        res = tempered_run(
            key, target.log_prob_fn, local_pos, eps,
            num_steps=num_steps, num_samples=num_samples,
            betas=local_betas, n_temps=n_temps, beta_min=beta_min,
            swap_interval=swap_interval, burn_in=0,
            inv_mass_matrix=inv_mass, gamma=gam, steepness=steep,
            friction_schedule=friction_schedule,
            value_and_grad_fn=target.value_and_grad_fn, backend=backend,
            init_replica_position=local_replica if have_replica else None)
        total_div = lax.psum(res.info["total_divergences"], CHAIN_AXIS)
        info = dict(
            res.info,
            total_divergences=total_div,
            divergence_rate=total_div.astype(jnp.float32)
            / max(num_samples * n_chains, 1),
            # equal chains per device: the global mean is the device mean
            swap_accept_rate=lax.psum(res.info["swap_accept_rate"],
                                      CHAIN_AXIS) / n_dev,
            # per-pair attempt totals over the whole mesh (identical per
            # device by construction — the sum is the honest global count)
            swap_attempts=lax.psum(res.info["swap_attempts"], CHAIN_AXIS),
            replica_accept_rate=lax.psum(res.info["replica_accept_rate"],
                                         CHAIN_AXIS) / n_dev,
            n_devices=jnp.asarray(n_dev, jnp.int32),
        )
        return res._replace(info=info)

    return run_shard(key, init_position, replica_position,
                     jnp.asarray(step_size, jnp.float32),
                     jnp.asarray(gamma, jnp.float32),
                     jnp.asarray(steepness, jnp.float32), inv_mass_matrix,
                     betas)


def nuts_persistent_run_sharded(
    key,
    target,
    init_position,
    mesh,
    step_size,
    num_samples: int,
    steps_per_sample: int = 64,
    burn_in_steps: int = 0,
    inv_mass_matrix=None,
    max_tree_depth: int = 10,
    delta_max: float = 1000.0,
    collect_chains_per_device: int = 8,
    proposal_scheme: str = "endpoint",
) -> RunResult:
    """Persistent NUTS (the XLA machine, samplers/nuts_persistent.py) with
    chains sharded over `mesh`'s chain axis.

    Each device runs its own asynchronous machine on its local chain shard
    (per-device fold_in RNG): chains never communicate, so the only
    collectives are the final psums for the global divergence/transition/
    leapfrog totals.
    """
    from mcmc_tpu.samplers.base import ChainState
    from mcmc_tpu.samplers.nuts_persistent import nuts_run_persistent

    n_chains, dim = init_position.shape
    n_dev = mesh.devices.size
    if n_chains % n_dev:
        raise ValueError(
            f"n_chains {n_chains} not divisible by mesh size {n_dev}")
    if inv_mass_matrix is None:
        inv_mass_matrix = jnp.ones(dim, jnp.float32)
    inv_mass_matrix = jnp.asarray(inv_mass_matrix, jnp.float32)
    init_position = shard_chains(jnp.asarray(init_position, jnp.float32),
                                 mesh)
    n_slots = (burn_in_steps + num_samples * steps_per_sample) * n_chains

    sharded = P(CHAIN_AXIS)
    out_specs = RunResult(
        samples=P(None, CHAIN_AXIS, None),
        log_probs=P(None, CHAIN_AXIS),
        accept_rate=sharded,
        final_state=ChainState(
            position=P(CHAIN_AXIS, None), log_prob=sharded,
            grad_log_prob=P(CHAIN_AXIS, None), accept_count=sharded,
            divergence_count=sharded),
        info={
            "divergence_count": sharded,
            "total_divergences": P(),
            "divergence_rate": P(),
            "transitions": sharded,
            "mean_accept_probs": sharded,
            "mean_tree_depth": sharded,
            "n_leapfrogs": P(),
            "n_leapfrogs_per_chain": sharded,
            "n_leapfrog_slots": P(),
            "final_positions": P(CHAIN_AXIS, None),
            "n_devices": P(),
        })

    @partial(shard_map_fn, mesh=mesh,
             in_specs=(P(), P(CHAIN_AXIS, None), P(), P()),
             out_specs=out_specs)
    def run_shard(key, local_pos, eps, inv_mass):
        key = random.fold_in(key, lax.axis_index(CHAIN_AXIS))
        res = nuts_run_persistent(
            key, target.log_prob_fn, local_pos, eps, num_samples,
            steps_per_sample=steps_per_sample, burn_in_steps=burn_in_steps,
            inv_mass_matrix=inv_mass, max_tree_depth=max_tree_depth,
            delta_max=delta_max, value_and_grad_fn=target.value_and_grad_fn,
            collect_chains=collect_chains_per_device,
            proposal_scheme=proposal_scheme)
        # lift the per-shard scalar totals to global psums; the counter
        # dtype follows the GLOBAL slot total (uint32 wraps past 2^32)
        count_dtype = _count_dtype(n_slots)
        total_div = lax.psum(res.info["total_divergences"], CHAIN_AXIS)
        total_trans = lax.psum(jnp.sum(res.info["transitions"]), CHAIN_AXIS)
        info = dict(
            res.info,
            total_divergences=total_div,
            divergence_rate=total_div.astype(jnp.float32)
            / jnp.maximum(total_trans, 1).astype(jnp.float32),
            n_leapfrogs=lax.psum(
                res.info["n_leapfrogs"].astype(count_dtype), CHAIN_AXIS),
            n_leapfrog_slots=lax.psum(
                res.info["n_leapfrog_slots"].astype(count_dtype), CHAIN_AXIS),
            n_devices=jnp.asarray(n_dev, jnp.int32),
        )
        return res._replace(info=info)

    return run_shard(key, init_position,
                     jnp.asarray(step_size, jnp.float32), inv_mass_matrix)


def smc_run_sharded(
    key,
    log_prob_fn,
    mesh,
    n_particles: int,
    dim: int,
    step_size,
    num_steps: int,
    betas=None,
    target_rel_ess: float = 0.5,
    resample_threshold: float = 0.5,
    move_steps: int = 3,
    max_stages: int = 200,
    base_mean=None,
    base_scale=1.0,
    inv_mass_matrix=None,
    gamma=0.0,
    steepness=1.0,
    friction_schedule: Optional[Callable] = None,
    value_and_grad_fn: Optional[Callable] = None,
    adapt_step_size: bool = True,
    final_resample: bool = False,
    tune_trajectory: bool = False,
    max_leapfrogs: Optional[int] = None,
    move_backend: str = "auto",
):
    """Annealed SMC (samplers/smc.py) with the particle population sharded
    over `mesh`'s chain axis.

    SMC's only cross-particle operations are weight reductions (reweight
    normalization, log-Z increments, the conditional-ESS bisection) and
    resampling. The reductions run as psum/pmax collectives inside the
    shard_map body (`_lse(axis_name=...)`), so the adaptive temperature
    while_loop, the resample decisions, and the Robbins-Monro step-size
    trajectory are computed from GLOBAL statistics and take identical
    branches on every device. Resampling stays island-local (each device
    systematically resamples its own shard; post-resample particles carry
    the island's total weight forward — the unbiased distributed-resampling
    scheme), so no particle data ever crosses a device boundary: per stage
    the wire traffic is a handful of scalars.

    Degenerate edge: if a single island's TOTAL weight underflows to zero
    (every local particle at -inf) its local resample is undefined — at
    the target_rel_ess=0.5 operating point the global ESS floor prevents
    this for any realistic shard size.

    n_particles is the GLOBAL population (must divide by the mesh size);
    returns the same SMCResult contract as smc_run with `particles` /
    `log_weights` / `final_state` device-sharded and every scalar and
    history buffer replicated. log_Z is identical (not just close) to a
    single-device run of the same per-device RNG streams.
    """
    from mcmc_tpu.samplers.base import ChainState
    from mcmc_tpu.samplers.smc import (SMCResult, _smc_run_jit,
                                       _validate_beta_schedule,
                                       resolve_move_backend)

    n_dev = mesh.devices.size
    if n_particles % n_dev:
        raise ValueError(
            f"n_particles {n_particles} not divisible by mesh size {n_dev}")
    local_p = n_particles // n_dev
    if local_p < 2:
        raise ValueError("need >= 2 particles per device")
    if not 0.0 < target_rel_ess < 1.0:
        raise ValueError("target_rel_ess must be in (0, 1)")
    if betas is not None and not isinstance(betas, jax.core.Tracer):
        _validate_beta_schedule(betas)
        betas = jnp.asarray(betas, jnp.float32)
        if int(betas.shape[0]) > max_stages:
            max_stages = int(betas.shape[0])
    if inv_mass_matrix is None:
        inv_mass_matrix = jnp.ones(dim, jnp.float32)
    inv_mass_matrix = jnp.asarray(inv_mass_matrix, jnp.float32)
    if max_leapfrogs is None:
        max_leapfrogs = max(4 * num_steps, 16)
    move_backend = resolve_move_backend(move_backend, value_and_grad_fn,
                                        tune_trajectory, inv_mass_matrix)

    sharded = P(CHAIN_AXIS)
    out_specs = SMCResult(
        particles=P(CHAIN_AXIS, None),
        log_weights=sharded,
        log_Z=P(),
        final_state=ChainState(
            position=P(CHAIN_AXIS, None), log_prob=sharded,
            grad_log_prob=P(CHAIN_AXIS, None), accept_count=sharded,
            divergence_count=sharded),
        info={k: P() for k in ("n_stages", "n_resamples", "n_divergences",
                               "ess", "final_step_size", "betas", "rel_ess",
                               "accept", "resampled", "step_size",
                               "n_leapfrogs", "final_trajectory_length",
                               "trajectory_length")})

    have_betas = betas is not None
    args = [key, jnp.asarray(step_size, jnp.float32), inv_mass_matrix]
    in_specs = [P(), P(), P()]
    if have_betas:
        args.append(betas)
        in_specs.append(P())

    @partial(shard_map_fn, mesh=mesh, in_specs=tuple(in_specs),
             out_specs=out_specs)
    def run_shard(key, eps, inv_mass, *maybe_betas):
        dkey = random.fold_in(key, lax.axis_index(CHAIN_AXIS))
        return _smc_run_jit(
            dkey, log_prob_fn, n_particles=local_p, dim=dim, step_size=eps,
            num_steps=num_steps,
            betas=maybe_betas[0] if have_betas else None,
            target_rel_ess=target_rel_ess,
            resample_threshold=resample_threshold, move_steps=move_steps,
            max_stages=max_stages, base_mean=base_mean,
            base_scale=base_scale, inv_mass_matrix=inv_mass, gamma=gamma,
            steepness=steepness, friction_schedule=friction_schedule,
            value_and_grad_fn=value_and_grad_fn,
            adapt_step_size=adapt_step_size, final_resample=final_resample,
            axis_name=CHAIN_AXIS, total_particles=n_particles,
            tune_trajectory=tune_trajectory, max_leapfrogs=max_leapfrogs,
            move_backend=move_backend,
            # the UNFOLDED key: every device draws the SAME jitter h per
            # move, so the traced leapfrog count — and with the psum'd
            # criterion gradient, the whole log-T trajectory — is
            # replicated across the mesh
            jitter_key=key)

    return run_shard(*args)
