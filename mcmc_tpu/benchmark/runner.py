"""Benchmark runner: the reference CLI contract on the batched JAX stack.

Schema and behavior parity with reference run_benchmarks.py (result field list
:831-888, grid-search selection :400-413, failure records :267-398, resume
:1063-1090, incremental save :938-1023), with these documented fixes:
- divergence_rate is REAL (|dH| > 1000 counted by the samplers) instead of the
  reference's hard-coded 0.0 placeholder (run_benchmarks.py:706-710),
- NUTS gradient accounting uses sum(2^depth - 1); HMC/GRAHMC use
  samples * L * chains everywhere including the convergence path (the
  reference is internally inconsistent — SURVEY.md §6 quirks).
"""

import copy
import csv
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

import jax.numpy as jnp
from jax import random

from mcmc_tpu.targets import get_target, get_reference_sampler, TargetDistribution
from mcmc_tpu.diagnostics import (
    compute_diagnostics, check_summary_statistics, compute_sliced_w2,
    ConvergenceW2Tracker,
    evaluate_gates, evaluate_smc_gates,
    MIN_ESS_QUALITY, MIN_ESS_TAIL_QUALITY,
    MIN_ESS_HARD_GATE, MIN_ESS_TAIL_HARD_GATE,
)
from mcmc_tpu.samplers import (
    rwmh_run, hmc_run, nuts_run, nuts_run_persistent, grahmc_run,
    get_friction_schedule, default_steepness,
)
from mcmc_tpu.tuning import run_adaptive_warmup, dual_averaging_tune_rwmh

ALL_TARGET_NAMES = [
    "standard_normal", "correlated_gaussian", "ill_conditioned_gaussian",
    "student_t", "log_gamma", "rosenbrock", "neals_funnel", "gaussian_mixture",
]

DEFAULT_L_GRID = [8, 16, 24, 32, 48, 64, 96]

# Fields copied from each grid run into grid_search_info["all_results"]
_GRID_SUMMARY_FIELDS = [
    "num_steps", "ess_per_gradient", "ess_bulk_min", "ess_tail_min",
    "rhat_max", "rhat_mean", "accept_rate", "step_size", "total_samples",
    "n_gradients", "warmup_time", "sample_time", "usable", "quality_pass",
    "divergence_rate", "sliced_w2", "z_score_max", "gamma", "steepness",
    # learned-metric stats: a failed grid arm is usually a warmup artifact
    # (bad mass matrix at that L), so post-mortems need these per L
    "mass_matrix_min", "mass_matrix_max", "mass_matrix_mean",
    # replica-exchange arms: ladder health per L
    "tempering", "swap_accept_rate",
]


def get_log_checkpoints(max_samples: int, base: float = 1.5,
                        quantum: int = None) -> List[int]:
    """Log-spaced checkpoint counts starting at 100, always ending at max.

    With ``quantum``, interior checkpoints snap to multiples of it so every
    checkpoint gap is a multiple of the quantum. The sampling loop then
    reuses ONE compiled quantum-width batch program across all checkpoint
    batches instead of compiling one program per distinct log-gap width —
    under jit (and especially under a shard_map mesh) the raw log grid's
    all-distinct gaps each pay a full XLA compile. Placement moves by at
    most quantum/2 per checkpoint, which no downstream consumer of the
    convergence trace resolves (the trace is plotted on log axes).
    """
    checkpoints = []
    current = 100.0
    while current < max_samples:
        checkpoints.append(int(current))
        current *= base
    checkpoints.append(max_samples)
    if not quantum or quantum <= 1:
        return checkpoints
    snapped = []
    for c in checkpoints[:-1]:
        q = max(quantum, int(round(c / quantum)) * quantum)
        if q < max_samples and (not snapped or q > snapped[-1]):
            snapped.append(q)
    snapped.append(max_samples)
    return snapped


def _checkpoint_chunks(batch: int, quantum: int) -> List[int]:
    """Split a checkpoint batch into fixed-width draw chunks.

    Interior batches are exact multiples of the quantum (see
    get_log_checkpoints); only the final batch can leave a remainder, so
    a whole tracked run compiles at most two sampling programs.
    """
    if quantum <= 1:
        return [batch]
    chunks = [quantum] * (batch // quantum)
    if batch % quantum:
        chunks.append(batch % quantum)
    return chunks


def _grid_summary(r: Dict) -> Dict:
    out = {k: r.get(k) for k in _GRID_SUMMARY_FIELDS}
    out.setdefault("ess_per_gradient", r.get("ess_per_gradient", 0))
    return out


def _warmup(sampler, target, target_name, key, init_pos, num_warmup,
            schedule_type, num_steps, learn_mass_matrix, verbose=True,
            backend="auto", nuts_backend="auto", mesh=None,
            trajectory_tuner="grid", nuts_proposal="endpoint",
            gamma_tuner="grid"):
    """Phase 1 dispatch. Returns (step_size, inv_mass, position, warmup_info).

    trajectory_tuner='chees' (hmc/grahmc) replaces the fixed-L windowed
    warmup with the ChEES joint (step, mass, trajectory-length) adaptation
    (tuning/chees.py) — warmup_info then carries the tuned
    trajectory_length and the equivalent num_steps, and `num_steps` from
    the caller is ignored. gamma_tuner='joint' (GRAHMC + chees only)
    additionally folds the friction into the same warmup via SPSA on the
    sphered ESJD (one phase produces eps, M, T, gamma; grid fallback on
    degenerate signal — tuning/chees.py)."""
    if sampler == "nuts" and nuts_backend == "persistent":
        backend = "persistent"
    if sampler == "rwmh":
        scale, _hist = dual_averaging_tune_rwmh(
            key, target.log_prob_fn, init_pos, max_iter=1000)
        return scale, None, init_pos, {"scale": scale}

    if trajectory_tuner == "chees" and sampler in ("hmc", "grahmc", "rahmc"):
        from mcmc_tpu.tuning.chees import run_chees_warmup
        return run_chees_warmup(
            "grahmc" if sampler == "rahmc" else sampler,
            target.log_prob_fn, None, init_pos, key,
            num_warmup=num_warmup,
            schedule_type=schedule_type if sampler in ("grahmc", "rahmc") else None,
            learn_mass_matrix=learn_mass_matrix,
            value_and_grad_fn=target.value_and_grad_fn,
            verbose=verbose,
            gamma=1.0,
            steepness=(default_steepness(schedule_type)
                       if sampler in ("grahmc", "rahmc") else None),
            mesh=mesh,
            gamma_tuner=gamma_tuner)

    kwargs = {}
    if sampler == "hmc":
        kwargs["num_steps"] = num_steps
    elif sampler == "nuts":
        kwargs["max_tree_depth"] = 15   # wider during warmup (reference :533)
        # the persistent warmup machine runs the SAME proposal scheme as
        # phase 2: the multinomial machine also terminates on sub-U-turns /
        # per-leaf divergences, so tuning on the endpoint machine would
        # adapt to slightly different trajectory dynamics (review finding)
        kwargs["nuts_proposal"] = nuts_proposal
    elif sampler in ("grahmc", "rahmc"):
        kwargs["num_steps"] = num_steps
        kwargs["gamma"] = 1.0
        kwargs["steepness"] = default_steepness(schedule_type)
    else:
        raise ValueError(f"Unknown sampler: {sampler}")

    step_size, inv_mass, pos, info = run_adaptive_warmup(
        "grahmc" if sampler == "rahmc" else sampler,
        target.log_prob_fn, None, init_pos, key,
        num_warmup=num_warmup, target_accept=0.65,
        schedule_type=schedule_type if sampler in ("grahmc", "rahmc") else None,
        learn_mass_matrix=learn_mass_matrix,
        value_and_grad_fn=target.value_and_grad_fn,
        verbose=verbose,
        backend=backend,
        mesh=mesh,
        **kwargs,
    )
    return step_size, inv_mass, pos, info


def _resolve_backend(sampler, target, backend: str = "auto") -> str:
    """The trajectory backend for HMC/GRAHMC (ops/padded_targets.
    resolve_backend: the fused kernel on a GPU for targets with kernel
    math); every other sampler runs XLA."""
    from mcmc_tpu.ops.padded_targets import resolve_backend
    if sampler in ("hmc", "grahmc", "rahmc"):
        return resolve_backend(backend, target.value_and_grad_fn)
    return "xla"


def _resolve_nuts_backend(nuts_backend: str, target) -> str:
    """Resolve the 'auto' NUTS backend (the CLI default).

    'auto' -> 'classic' (reference semantics, reference samplers/
    NUTS.py:380-442) until a bench cell compares it with the persistent
    machine on the GPU (ROADMAP). Explicit values pass through, so
    `--nuts-backend persistent` selects the asynchronous machine
    (samplers/nuts_persistent.py).
    """
    if nuts_backend != "auto":
        return nuts_backend
    return "classic"


def _resolve_mesh(n_chains: int, mesh_devices="auto"):
    """Build the chain mesh for multi-chip runs, or None for single-device.

    mesh_devices: "auto" uses all local devices when >1 (chains permitting);
    an int requests that many devices; "off"/None/0/1 disables sharding.
    """
    import jax
    from mcmc_tpu.parallel import make_mesh
    if mesh_devices in (None, "off", 0, 1):
        return None
    n_avail = len(jax.devices())
    n_dev = n_avail if mesh_devices == "auto" else int(mesh_devices)
    if n_dev <= 1:
        return None
    if n_dev > n_avail:
        raise ValueError(f"--mesh {n_dev} requested but only {n_avail} devices")
    if n_chains % n_dev:
        print(f"  [mesh] n_chains={n_chains} not divisible by {n_dev} devices; "
              f"running single-device")
        return None
    return make_mesh(n_dev)


def _sample(sampler, target, key, position, step_size, num_steps, num_samples,
            inv_mass, schedule_type, warmup_info, backend: str = "auto",
            mesh=None, nuts_backend: str = "auto",
            nuts_steps_per_sample: int = 64,
            nuts_proposal: str = "endpoint",
            tempering: int = 0, tempering_beta_min: float = 0.05,
            tempering_swap_interval: int = 1, replica_position=None,
            tempering_betas=None, tempering_step_sizes=None):
    """Phase 2 dispatch. Returns a RunResult.

    With a mesh, XLA samplers run GSPMD-partitioned over the chain axis
    (positions are sharded by the caller; chains are communication-free), and
    the fused Pallas path — opaque to the GSPMD partitioner — dispatches to
    the explicit shard_map wrapper (parallel/fused_sharded.py).

    tempering > 1 (hmc/grahmc only) runs the replica-exchange ladder
    (samplers/tempered.py) over the shared transition: K tempered replicas,
    geometric ladder to tempering_beta_min, the cold replica's draws
    emitted. replica_position threads the full (K*C, D) ladder state across
    convergence-checkpoint batches.
    """
    backend = _resolve_backend(sampler, target, backend)
    if nuts_backend == "auto":
        nuts_backend = _resolve_nuts_backend(nuts_backend, target)
    if tempering and tempering > 1 and sampler in ("hmc", "grahmc", "rahmc"):
        from mcmc_tpu.samplers.tempered import tempered_run
        is_hmc = sampler == "hmc"
        # explicit per-rung steps (ladder tuner) override the
        # eps/sqrt(beta) default derived from the scalar cold step
        if tempering_step_sizes is not None:
            step_size = jnp.asarray(tempering_step_sizes, jnp.float32)
        if mesh is not None:
            from mcmc_tpu.parallel.fused_sharded import tempered_run_sharded
            return tempered_run_sharded(
                key, target, position, mesh, step_size=step_size,
                num_steps=num_steps, num_samples=num_samples,
                n_temps=tempering, swap_interval=tempering_swap_interval,
                beta_min=tempering_beta_min, inv_mass_matrix=inv_mass,
                gamma=0.0 if is_hmc else warmup_info.get("gamma", 1.0),
                steepness=0.0 if is_hmc else warmup_info.get("steepness", 5.0),
                friction_schedule=(None if is_hmc
                                   else get_friction_schedule(schedule_type)),
                backend=backend,
                replica_position=replica_position, betas=tempering_betas)
        return tempered_run(
            key, target.log_prob_fn, position, step_size,
            num_steps=num_steps, num_samples=num_samples,
            betas=tempering_betas,
            n_temps=tempering, beta_min=tempering_beta_min,
            swap_interval=tempering_swap_interval, burn_in=0,
            inv_mass_matrix=inv_mass,
            gamma=0.0 if is_hmc else warmup_info.get("gamma", 1.0),
            steepness=0.0 if is_hmc else warmup_info.get("steepness", 5.0),
            friction_schedule=(None if is_hmc
                               else get_friction_schedule(schedule_type)),
            value_and_grad_fn=target.value_and_grad_fn,
            backend=backend,
            init_replica_position=replica_position)
    if mesh is not None and sampler == "nuts" and nuts_backend == "persistent":
        # the XLA machine shard_mapped per device: chains never talk, so
        # each device runs its own machine on its shard
        from mcmc_tpu.parallel.fused_sharded import nuts_persistent_run_sharded
        n_local = position.shape[0] // mesh.devices.size
        return nuts_persistent_run_sharded(
            key, target, position, mesh, step_size=step_size,
            num_samples=num_samples,
            steps_per_sample=nuts_steps_per_sample, burn_in_steps=0,
            inv_mass_matrix=inv_mass, max_tree_depth=10,
            collect_chains_per_device=n_local,
            proposal_scheme=nuts_proposal)
    if (mesh is not None and backend != "xla"
            and sampler in ("hmc", "grahmc", "rahmc")):
        # pallas_call is opaque to the GSPMD partitioner: the kernel path
        # is shard_mapped explicitly
        from mcmc_tpu.parallel.fused_sharded import grahmc_run_sharded
        is_hmc = sampler == "hmc"
        n_local = position.shape[0] // mesh.devices.size
        return grahmc_run_sharded(
            key, target, position, mesh, step_size=step_size,
            num_steps=num_steps,
            gamma=0.0 if is_hmc else warmup_info.get("gamma", 1.0),
            steepness=0.0 if is_hmc else warmup_info.get("steepness", 5.0),
            num_samples=num_samples, burn_in=0, inv_mass_matrix=inv_mass,
            friction_schedule=(None if is_hmc
                               else get_friction_schedule(schedule_type)),
            collect_chains_per_device=n_local,
            backend=backend)
    if sampler == "rwmh":
        return rwmh_run(key, target.log_prob_fn, position,
                        num_samples=num_samples, scale=step_size, burn_in=0)
    if sampler == "hmc":
        return hmc_run(key, target.log_prob_fn, position, step_size=step_size,
                       num_steps=num_steps, num_samples=num_samples, burn_in=0,
                       inv_mass_matrix=inv_mass,
                       value_and_grad_fn=target.value_and_grad_fn,
                       backend=backend)
    if sampler == "nuts":
        if nuts_backend == "persistent":
            # asynchronous NUTS, fixed-interval snapshots
            # (samplers/nuts_persistent.py). Exact gradient accounting via
            # info["n_leapfrogs"].
            return nuts_run_persistent(
                key, target.log_prob_fn, position, step_size=step_size,
                num_samples=num_samples,
                steps_per_sample=nuts_steps_per_sample, burn_in_steps=0,
                inv_mass_matrix=inv_mass, max_tree_depth=10,
                value_and_grad_fn=target.value_and_grad_fn,
                proposal_scheme=nuts_proposal)
        return nuts_run(key, target.log_prob_fn, position, step_size=step_size,
                        num_samples=num_samples, burn_in=0,
                        inv_mass_matrix=inv_mass, max_tree_depth=10,
                        value_and_grad_fn=target.value_and_grad_fn)
    if sampler in ("grahmc", "rahmc"):
        return grahmc_run(
            key, target.log_prob_fn, position, step_size=step_size,
            num_steps=num_steps, gamma=warmup_info.get("gamma", 1.0),
            steepness=warmup_info.get("steepness", 5.0),
            num_samples=num_samples, burn_in=0, inv_mass_matrix=inv_mass,
            friction_schedule=get_friction_schedule(schedule_type),
            value_and_grad_fn=target.value_and_grad_fn, backend=backend)
    raise ValueError(f"Unknown sampler: {sampler}")


def run_single_benchmark_with_L(
    sampler: str,
    target: TargetDistribution,
    target_name: str,
    key,
    n_chains: int,
    num_warmup: int,
    num_samples: int,
    schedule_type: str,
    num_steps: int,
    learn_mass_matrix: bool = True,
    track_convergence: bool = False,
    convergence_base: float = 1.5,
    mesh_devices="auto",
    nuts_backend: str = "auto",
    warmup_cache_dir: Optional[str] = None,
    nuts_steps_per_sample: int = 64,
    trajectory_tuner: str = "grid",
    gamma_tuner: str = "grid",
    nuts_proposal: str = "endpoint",
    tempering: int = 0,
    tempering_beta_min: float = 0.05,
    tempering_swap_interval: int = 1,
    tempering_ladder: str = "geometric",
) -> Dict:
    """One warmup+sample+diagnose+gate pipeline at a fixed trajectory length.

    tempering=K (> 1, hmc/grahmc only) samples through the K-rung replica-
    exchange ladder (samplers/tempered.py): warmup tunes step/metric on the
    cold (beta=1) chain as usual, hotter replicas run at eps/sqrt(beta), and
    the emitted draws are the cold replica's. n_gradients counts ALL K
    replicas' leapfrogs.

    tempering_ladder: 'geometric' (fixed geometric_ladder to beta_min) or
    'adaptive' (Phase 1b: Robbins-Monro on the ladder's log-spacings toward
    uniform 0.234 swap acceptance, tuning/ladder.py — short tempered bursts
    reusing the ONE jitted tempered_run, betas traced; the sampling phase
    then runs the tuned ladder and continues from the burst-equilibrated
    replica state).

    warmup_cache_dir: when set, Phase-1 products (tuned step, learned
    metric, warmed positions, friction params) are checkpointed per run
    signature and restored on re-entry — a crashed grid re-run skips the
    2500-step warmups it already paid for (the reference resumes only
    COMPLETED configurations; its chain state is never persisted,
    SURVEY.md §5).

    trajectory_tuner='chees' (hmc/grahmc only): the caller's num_steps is
    ignored; warmup tunes the trajectory length jointly (tuning/chees.py)
    and Phase 2 samples with QUANTIZED-JITTERED trajectories around the
    tuned T (chees_run) — n_gradients then counts the realized leapfrogs,
    not num_samples * L."""
    is_grahmc = sampler in ("grahmc", "rahmc")
    use_tempering = (tempering and tempering > 1
                     and sampler in ("hmc", "grahmc", "rahmc"))
    if use_tempering and trajectory_tuner == "chees":
        # same contract run_all_benchmarks enforces — the ChEES criterion
        # would adapt to the cold replica only, and the ChEES sampling path
        # has no ladder to report
        raise ValueError("tempering composes with the fixed-L pipeline, "
                         "not the ChEES tuner; drop one of the two")
    if tempering_ladder not in ("geometric", "adaptive"):
        raise ValueError(f"tempering_ladder must be 'geometric' or "
                         f"'adaptive', got {tempering_ladder!r}")
    header = f"BENCHMARK: {sampler.upper()} on {target.name}"
    if is_grahmc:
        header += f" [{schedule_type}]"
    if use_tempering:
        header += f" [tempered K={tempering}]"
    print(f"\n{'=' * 80}\n{header}  (L={num_steps}, "
          f"mass={'learned' if learn_mass_matrix else 'identity'})\n{'=' * 80}")

    start_time = time.time()
    if sampler == "nuts":
        nuts_backend = _resolve_nuts_backend(nuts_backend, target)
        print(f"  [nuts] backend: {nuts_backend}")
    try:
        key, init_key = random.split(key)
        if target.init_sampler is not None:
            init_pos = target.init_sampler(init_key, n_chains)
        else:
            init_pos = random.normal(init_key, (n_chains, target.dim)) * 0.1

        mesh = _resolve_mesh(n_chains, mesh_devices)
        if mesh is not None:
            from mcmc_tpu.parallel import shard_chains
            init_pos = shard_chains(init_pos, mesh)
            print(f"  [mesh] chains sharded over {mesh.devices.size} devices")

        # Phase 1: adaptive warmup. Under a mesh, the window scans run
        # shard_mapped so the fused kernels execute per device on their
        # local chain shard (tuning/adaptation.py mesh path; the
        # backend="xla" GSPMD fallback of rounds 1-2 is gone — VERDICT r2 #3).
        # The chees tuner only applies to trajectory samplers — a stray
        # trajectory_tuner flag on a NUTS/RWMH call must not perturb their
        # warmup-cache keys or invalidate their checkpoints.
        use_chees = (trajectory_tuner == "chees"
                     and sampler in ("hmc", "grahmc", "rahmc"))
        warmup_sig = cached = None
        if warmup_cache_dir is not None:
            from mcmc_tpu.utils.checkpoint import (load_warmup,
                                                   warmup_signature)
            warmup_sig = warmup_signature(
                sampler, target_name, schedule_type if is_grahmc else None,
                # chees ignores the caller's L: key the cache on the tuner
                0 if use_chees else num_steps,
                learn_mass_matrix, n_chains, target.dim,
                num_warmup=num_warmup,
                # endpoint keeps the pre-scheme signature so existing
                # caches stay valid; multinomial gets a distinct key (its
                # warmup runs the multinomial machine)
                backend=((nuts_backend if nuts_proposal == "endpoint"
                          else f"{nuts_backend}-{nuts_proposal}")
                         if sampler == "nuts" else
                         # the joint gamma tuner only activates for
                         # grahmc/rahmc — HMC ChEES warmups are identical
                         # either way, so keep them under one cache key
                         ("chees" if (gamma_tuner == "grid"
                                      or sampler == "hmc")
                          else f"chees-{gamma_tuner}")
                         if use_chees else ""))
            cached = load_warmup(warmup_cache_dir, warmup_sig)
            if (cached is not None and use_chees
                    and "trajectory_length" not in cached[3]):
                cached = None   # stale pre-chees checkpoint: re-run warmup
        warmup_start = time.time()
        # consume the warmup key unconditionally so a cache-hit run draws
        # the SAME sampling keys as an uninterrupted run of this seed
        key, warm_key = random.split(key)
        if cached is not None:
            step_size, inv_mass, position, warmup_info = cached
            if mesh is not None:
                from mcmc_tpu.parallel import shard_chains
                position = shard_chains(position, mesh)
            warmup_restored = True
            print(f"[Phase 1] Warmup restored from checkpoint "
                  f"({warmup_sig}): step_size={step_size:.4f}")
        else:
            print("[Phase 1] Adaptive warmup...")
            step_size, inv_mass, position, warmup_info = _warmup(
                sampler, target, target_name, warm_key, init_pos, num_warmup,
                schedule_type, num_steps, learn_mass_matrix,
                backend="auto", nuts_backend=nuts_backend, mesh=mesh,
                trajectory_tuner=trajectory_tuner,
                nuts_proposal=nuts_proposal, gamma_tuner=gamma_tuner)
            warmup_restored = False
            if warmup_cache_dir is not None:
                from mcmc_tpu.utils.checkpoint import save_warmup
                save_warmup(warmup_cache_dir, warmup_sig, step_size,
                            inv_mass, position, warmup_info)
        warmup_time = time.time() - warmup_start
        print(f"  warmup {warmup_time:.1f}s, step_size={step_size:.4f}")

        # Phase 1b: adaptive tempering ladder (tuning/ladder.py). Each
        # round is one short tempered burst through _sample (same fused /
        # mesh dispatch as Phase 2; betas are a TRACED operand of the
        # jitted tempered_run, so all rounds share one executable), the
        # host does the K-1-scalar Robbins-Monro update between rounds.
        tempering_betas = None
        tempering_steps = None
        ladder_replica_pos = None
        ladder_meta = {}
        if use_tempering and tempering_ladder == "adaptive":
            from mcmc_tpu.tuning.dual_averaging import TARGET_ACCEPT_HMC
            from mcmc_tpu.tuning.ladder import tune_ladder
            print("[Phase 1b] Adapting tempering ladder "
                  "(Robbins-Monro on log-spacings, target swap 0.234; "
                  "per-rung steps toward accept "
                  f"{TARGET_ACCEPT_HMC})...")
            ladder_start = time.time()
            key, ladder_key = random.split(key)
            ladder_round = [0]
            # a burst must span >= 2 swap phases (even AND odd pairs) or
            # some pairs are never attempted and the tuner cannot see them
            burst_draws = max(16, 2 * tempering_swap_interval)

            def _ladder_burst(betas, steps, replica_pos):
                k = random.fold_in(ladder_key, ladder_round[0])
                ladder_round[0] += 1
                r = _sample(sampler, target, k, position, step_size,
                            num_steps, burst_draws, inv_mass, schedule_type,
                            warmup_info, mesh=mesh, tempering=tempering,
                            tempering_beta_min=tempering_beta_min,
                            tempering_swap_interval=tempering_swap_interval,
                            replica_position=replica_pos,
                            tempering_betas=betas,
                            tempering_step_sizes=steps)
                return (np.asarray(r.info["swap_accept_rate"]),
                        np.asarray(r.info["swap_attempts"]),
                        np.asarray(r.info["replica_accept_rate"]),
                        r.info["replica_final_positions"])

            tempering_betas, ladder_info = tune_ladder(
                _ladder_burst, tempering,
                beta_min_init=tempering_beta_min, n_rounds=16,
                step_size=float(step_size),
                target_accept=TARGET_ACCEPT_HMC)
            tempering_steps = ladder_info["step_sizes"]
            # continue sampling from the burst-equilibrated FULL ladder
            # (hot rungs included) instead of rewinding to warmup output
            ladder_replica_pos = ladder_info["replica_final_positions"]
            ladder_time = time.time() - ladder_start
            ladder_meta = {
                "tempering_ladder": "adaptive",
                "ladder_tune_time": ladder_time,
                "ladder_rounds": ladder_info["n_rounds"],
                "ladder_initial_deviation": ladder_info["initial_deviation"],
                "ladder_final_deviation": ladder_info["final_deviation"],
                "tempering_step_sizes": [round(float(x), 5)
                                         for x in tempering_steps],
            }
            print(f"  ladder {ladder_time:.1f}s, mean|A-0.234| "
                  f"{ladder_info['initial_deviation']:.3f} -> "
                  f"{ladder_info['final_deviation']:.3f}, beta_min="
                  f"{float(tempering_betas[-1]):.4f}, steps="
                  f"{[round(float(x), 3) for x in tempering_steps]}")
        elif use_tempering:
            ladder_meta = {"tempering_ladder": "geometric"}

        if use_chees:
            num_steps = warmup_info["num_steps"]
            chees_T = warmup_info["trajectory_length"]
            if warmup_info.get("max_steps_cap_hit"):
                # Criterion runaway (flat-tailed target): sampling at the
                # capped trajectory would be the most expensive possible
                # configuration, and run_all_benchmarks discards the result
                # anyway — return the cap verdict without paying Phase 2-4.
                print("  [chees] trajectory cap hit — skipping sampling "
                      "(caller should fall back to the L grid search)")
                return {
                    "sampler": sampler, "target": target.name,
                    "schedule": schedule_type if is_grahmc else None,
                    "mass_matrix_learned": learn_mass_matrix,
                    "trajectory_tuner": "chees", "chees_cap_hit": True,
                    "chees_trajectory_length": chees_T,
                    "num_steps": num_steps, "step_size": step_size,
                    "warmup_time": warmup_time,
                    "error": "chees trajectory cap hit (criterion runaway)",
                }
            print(f"  [chees] trajectory tuned: T={chees_T:.4f} "
                  f"-> L={num_steps} (jittered sampling)")

        def _chees_sample(s_key, pos, n_draws, offset):
            from mcmc_tpu.tuning.chees import chees_run
            return chees_run(
                s_key, target.log_prob_fn, pos, step_size, chees_T,
                n_draws, inv_mass_matrix=inv_mass,
                value_and_grad_fn=target.value_and_grad_fn,
                schedule_type=(schedule_type if is_grahmc else None),
                gamma=warmup_info.get("gamma", 0.0),
                steepness=warmup_info.get("steepness", 1.0),
                halton_offset=offset, mesh=mesh)

        # Phase 2: sampling (optionally with convergence checkpoints)
        convergence_trace = None
        tempered_run_stats = None   # whole-run ladder stats (checkpointed path)
        chees_leapfrogs = 0
        halton_cursor = warmup_info.get("halton_offset", 0) if use_chees else 0
        run_betas = None            # realized ladder (tempered metadata)
        sampling_ckpt = None
        sample_start = time.time()
        if track_convergence and sampler in ("hmc", "grahmc", "rahmc"):
            # Fixed-width chunking: snap checkpoints to a quantum grid and
            # run every batch as repeated quantum-width calls of one
            # compiled program (two programs max per run, vs one per
            # distinct log gap — the dominant cost of tracked runs, worst
            # under a mesh where each width is a fresh shard_map compile).
            quantum = min(50, max(1, num_samples // 4))
            checkpoints = get_log_checkpoints(
                num_samples, base=convergence_base, quantum=quantum)
            print(f"[Phase 2] Sampling with {len(checkpoints)} convergence "
                  f"checkpoints (chunk width {quantum})...")
            convergence_trace = []
            piece_samples = []      # one (chunk, C, D) array per chunk
            piece_stats = []        # per-chunk JSON-safe stats
            prev = 0
            res = None
            replica_pos = ladder_replica_pos
            # one reference draw + direction set for the whole trace: each
            # checkpoint pays only its own sample sort, not the (50k, 500)
            # reference-side sort (see ConvergenceW2Tracker); the headline
            # sliced_w2 below still uses the fresh-draw parity path
            key, w2_key = random.split(key)

            # Mid-sampling checkpoint/resume (round 5, VERDICT r4 #4):
            # chain state + partial history + RNG keys persist at every
            # convergence checkpoint, so a preemption resumes from the
            # last checkpoint instead of repaying the whole sampling
            # phase. Draw-exact: the resumed key sequence is identical.
            if warmup_sig is not None:
                from mcmc_tpu.utils.checkpoint import SamplingCheckpoint
                sampling_ckpt = SamplingCheckpoint(
                    warmup_cache_dir, warmup_sig, config={
                        "num_samples": int(num_samples),
                        "quantum": int(quantum),
                        "convergence_base": float(convergence_base),
                        "tempering": int(tempering or 0),
                        "chees": bool(use_chees),
                        "step_size": float(step_size),
                    })
                restored = sampling_ckpt.load()
                if restored is not None and restored["prev"] > 0:
                    prev = restored["prev"]
                    key = restored["key"]
                    w2_key = restored["w2_key"]
                    position = restored["position"]
                    halton_cursor = restored["halton_cursor"]
                    chees_leapfrogs = restored["chees_leapfrogs"]
                    convergence_trace = restored["convergence_trace"]
                    piece_samples = restored["piece_samples"]
                    piece_stats = restored["piece_stats"]
                    if mesh is not None:
                        from mcmc_tpu.parallel import shard_chains
                        position = shard_chains(position, mesh)
                    if restored["replica_pos"] is not None:
                        replica_pos = restored["replica_pos"]
                        if mesh is not None:
                            replica_pos = shard_chains(replica_pos, mesh)
                    print(f"  [resume] mid-sampling checkpoint restored "
                          f"at draw {prev}/{num_samples}")

            w2_tracker = ConvergenceW2Tracker(target_name, target.dim,
                                              n_reference=50000,
                                              n_projections=500, key=w2_key)
            for cp in checkpoints:
                if cp <= prev:
                    continue    # completed before the restored checkpoint
                batch = cp - prev
                prev = cp
                for chunk in _checkpoint_chunks(batch, quantum):
                    key, s_key = random.split(key)
                    if use_chees:
                        res = _chees_sample(s_key, position, chunk,
                                            halton_cursor)
                        halton_cursor += chunk
                        chees_leapfrogs += res.info["total_leapfrogs"]
                    else:
                        res = _sample(
                            sampler, target, s_key, position, step_size,
                            num_steps, chunk, inv_mass, schedule_type,
                            warmup_info, mesh=mesh,
                            nuts_backend=nuts_backend,
                            nuts_steps_per_sample=nuts_steps_per_sample,
                            nuts_proposal=nuts_proposal,
                            tempering=tempering,
                            tempering_beta_min=tempering_beta_min,
                            tempering_swap_interval=tempering_swap_interval,
                            replica_position=replica_pos,
                            tempering_betas=tempering_betas,
                            tempering_step_sizes=tempering_steps)
                        # tempered chunks continue the FULL ladder, not
                        # just the cold rows — hot rungs stay equilibrated
                        replica_pos = res.info.get("replica_final_positions")
                    position = res.final_state.position
                    piece_samples.append(res.samples)
                    st = {"draws": int(res.samples.shape[0]),
                          "accept_mean": float(res.accept_rate.mean()),
                          "total_divergences": int(
                              res.info["total_divergences"])}
                    if use_tempering:
                        st["swap_attempts"] = np.asarray(
                            res.info["swap_attempts"], np.float64).tolist()
                        st["swap_accept_rate"] = np.asarray(
                            res.info["swap_accept_rate"],
                            np.float64).tolist()
                        st["replica_accept_rate"] = np.asarray(
                            res.info["replica_accept_rate"],
                            np.float64).tolist()
                        st["betas"] = np.asarray(res.info["betas"],
                                                 np.float64).tolist()
                    piece_stats.append(st)
                cumulative = jnp.concatenate(piece_samples, axis=0)
                w2 = w2_tracker.w2(cumulative) if w2_tracker.ok else None
                cp_diag = compute_diagnostics(cumulative)
                n_grad_cp = (chees_leapfrogs if use_chees
                             else cp * num_steps) * n_chains
                if use_tempering:
                    # same xK the headline n_gradients charges: every
                    # replica burns L grads per chain per draw
                    n_grad_cp *= tempering
                convergence_trace.append({
                    "checkpoint": int(cp),
                    "n_gradients": int(n_grad_cp),
                    "w2_distance": float(w2) if w2 is not None else None,
                    "ess_bulk_min": float(cp_diag["ess_bulk_min"]),
                    "ess_tail_min": float(cp_diag["ess_tail_min"]),
                    "rhat_max": float(cp_diag["rhat_max"]),
                })
                if sampling_ckpt is not None:
                    sampling_ckpt.save(
                        prev, key, w2_key, position,
                        replica_pos if use_tempering else None,
                        halton_cursor, chees_leapfrogs, convergence_trace,
                        piece_samples, piece_stats)
            samples = jnp.concatenate(piece_samples, axis=0)
            piece_draws = np.array([s["draws"] for s in piece_stats],
                                   np.float64)
            accept_rate = float(np.sum(
                [s["accept_mean"] * d
                 for s, d in zip(piece_stats, piece_draws)])
                / piece_draws.sum())
            total_div = int(sum(s["total_divergences"] for s in piece_stats))
            divergence_rate = total_div / (num_samples * n_chains)
            tree_depths = None
            if use_tempering:
                # whole-run ladder health, not the last checkpoint batch's:
                # swap rates aggregate exactly via their attempt counts
                # (sum acc / sum att), replica acceptance via piece draws
                att = np.array([s["swap_attempts"] for s in piece_stats])
                acc = np.array([s["swap_accept_rate"] for s in piece_stats])
                rep = np.array([s["replica_accept_rate"]
                                for s in piece_stats])
                tempered_run_stats = {
                    "swap_accept_rate": (acc * att).sum(0)
                    / np.maximum(att.sum(0), 1.0),
                    "replica_accept_rate":
                    (rep * piece_draws[:, None]).sum(0) / piece_draws.sum(),
                }
                run_betas = piece_stats[-1]["betas"]
        else:
            print(f"[Phase 2] Sampling {num_samples} draws...")
            key, s_key = random.split(key)
            if use_chees:
                res = _chees_sample(s_key, position, num_samples,
                                    halton_cursor)
                chees_leapfrogs += res.info["total_leapfrogs"]
            else:
                res = _sample(sampler, target, s_key, position, step_size,
                              num_steps, num_samples, inv_mass, schedule_type,
                              warmup_info, mesh=mesh,
                              nuts_backend=nuts_backend,
                              nuts_steps_per_sample=nuts_steps_per_sample,
                              nuts_proposal=nuts_proposal,
                              tempering=tempering,
                              tempering_beta_min=tempering_beta_min,
                              tempering_swap_interval=tempering_swap_interval,
                              replica_position=ladder_replica_pos,
                              tempering_betas=tempering_betas,
                              tempering_step_sizes=tempering_steps)
            samples = res.samples
            accept_rate = float(res.accept_rate.mean())
            total_div = int(res.info["total_divergences"])
            divergence_rate = float(res.info["divergence_rate"])
            tree_depths = res.info.get("tree_depths")
        sample_time = time.time() - sample_start
        print(f"  sampling {sample_time:.1f}s, accept={accept_rate:.3f}, "
              f"div={divergence_rate:.2%}")

        # Gradient accounting
        if (sampler == "nuts" and res is not None
                and "n_leapfrogs" in getattr(res, "info", {})):
            # persistent path: exact count of executed (all useful) leapfrogs
            n_gradients = int(res.info["n_leapfrogs"])
            avg_tree_depth = float(np.asarray(
                res.info["mean_tree_depth"]).mean())
        elif sampler == "nuts" and tree_depths is not None:
            grads_per = (2 ** np.asarray(tree_depths)) - 1
            n_gradients = int(grads_per.sum())
            avg_tree_depth = float(np.asarray(tree_depths).mean())
        elif sampler == "rwmh":
            n_gradients, avg_tree_depth = 0, None
        elif use_chees:
            # jittered draws are cheaper than num_samples * L_max: count
            # the leapfrogs that actually executed
            n_gradients = chees_leapfrogs * n_chains
            avg_tree_depth = None
        else:
            n_gradients = num_samples * num_steps * n_chains
            if use_tempering:
                # every replica burns L grads per chain per draw; the
                # ladder's cost is charged honestly to ESS/gradient
                n_gradients *= tempering
            avg_tree_depth = None

        # Sampler metadata
        if sampler == "rwmh":
            sampler_metadata = {"scale": step_size}
        elif sampler == "hmc":
            sampler_metadata = {"step_size": step_size, "num_steps": num_steps,
                                "backend": _resolve_backend(sampler, target)}
        elif sampler == "nuts":
            sampler_metadata = {"step_size": step_size, "max_tree_depth": 10,
                                "avg_tree_depth": avg_tree_depth,
                                "nuts_backend": nuts_backend}
            if nuts_backend == "persistent":
                sampler_metadata["nuts_steps_per_sample"] = nuts_steps_per_sample
                sampler_metadata["nuts_proposal"] = nuts_proposal
        else:
            sampler_metadata = {"step_size": step_size, "num_steps": num_steps,
                                "gamma": warmup_info.get("gamma", 1.0),
                                "steepness": warmup_info.get("steepness", 5.0),
                                "schedule": schedule_type,
                                "backend": _resolve_backend(sampler, target)}
            if "gamma_tuner" in warmup_info:
                # which friction tuner actually produced gamma: 'joint'
                # (SPSA inside the ChEES warmup) or 'grid' (sequential
                # ESJD phase, incl. the joint mode's degenerate-signal
                # fallback — tuning/chees.py)
                sampler_metadata["gamma_tuner"] = warmup_info["gamma_tuner"]
        if use_tempering and (res is not None or run_betas is not None):
            # checkpointed runs report WHOLE-run ladder health (counters
            # reset per _sample call, so res.info alone covers only the
            # final batch); single-shot runs use res.info directly. A run
            # fully restored from a mid-sampling checkpoint has res=None
            # and reads the ladder from the persisted piece stats.
            swap_stats = tempered_run_stats or res.info
            if run_betas is None:
                run_betas = res.info["betas"]
            sampler_metadata.update(
                tempering=int(tempering),
                tempering_beta_min=float(tempering_beta_min),
                tempering_swap_interval=int(tempering_swap_interval),
                swap_accept_rate=[round(float(x), 4)
                                  for x in np.asarray(
                                      swap_stats["swap_accept_rate"])],
                replica_accept_rate=[round(float(x), 4)
                                     for x in np.asarray(
                                         swap_stats["replica_accept_rate"])],
                tempering_betas=[round(float(x), 4)
                                 for x in np.asarray(run_betas)],
                **ladder_meta)
        if use_chees:
            sampler_metadata.update(
                trajectory_tuner="chees",
                chees_trajectory_length=chees_T,
                # run-wide realized mean (a cap-hit warmup returns before
                # sampling, so chees_leapfrogs here covers EVERY draw —
                # the last checkpoint batch alone would misstate it under
                # convergence tracking)
                mean_num_steps=chees_leapfrogs / num_samples)

        # Phase 3: diagnostics + gates
        print("[Phase 3] Diagnostics...")
        diagnostics = compute_diagnostics(samples)
        stats_result = check_summary_statistics(diagnostics, target,
                                                significance=0.05)
        stats_pass = stats_result["pass"]
        has_true_mean = target.true_mean is not None and target.true_cov is not None

        # Reparameterized targets (unconstrain_target): z-test the
        # CONSTRAINED coordinates too — transformed draws vs the original
        # target's analytic moments — and gate quality_pass on it. R-hat/ESS
        # stay in the sampled coordinates (Stan practice: diagnose the
        # parameterization you sample); this check proves the transform
        # recovers the right posterior, not just a well-mixed wrong one.
        stats_result_t = None
        if (target.transform is not None
                and target.transform_true_mean is not None
                and target.transform_true_cov is not None):
            from types import SimpleNamespace
            diag_t = compute_diagnostics(np.asarray(target.transform(samples)))
            stats_result_t = check_summary_statistics(
                diag_t, SimpleNamespace(true_mean=target.transform_true_mean,
                                        true_cov=target.transform_true_cov),
                significance=0.05)
            stats_pass = stats_pass and stats_result_t["pass"]
            has_true_mean = True

        gates = evaluate_gates(
            diagnostics["rhat_max"], diagnostics["ess_bulk_min"],
            diagnostics["ess_tail_min"], divergence_rate, num_samples,
            stats_pass, has_true_mean)

        total_time = time.time() - start_time

        # Phase 4: Sliced-W2 vs ground truth
        ref_sampler = get_reference_sampler(target_name, target.dim)
        if ref_sampler is not None:
            print("[Phase 4] Sliced W2...")
            key, w2_key = random.split(key)
            sliced_w2 = compute_sliced_w2(samples, target_name, target.dim,
                                          n_reference=50000, n_projections=500,
                                          key=w2_key)
        else:
            sliced_w2 = None

        # Reparameterized targets: also measure W2 in the TRANSFORMED
        # coordinates against the transform target's own ground truth
        # (e.g. non-centered funnel draws mapped to centered-funnel
        # coordinates vs the centered funnel's exact sampler).
        sliced_w2_transformed = None
        if (target.transform is not None
                and target.transform_target is not None):
            key, w2t_key = random.split(key)
            sliced_w2_transformed = compute_sliced_w2(
                target.transform(samples), target.transform_target,
                target.dim, n_reference=50000, n_projections=500,
                key=w2t_key)

        results = {
            "sampler": sampler,
            "target": target.name,
            "schedule": schedule_type if is_grahmc else None,
            "dim": target.dim,
            "num_steps": num_steps if sampler in ("hmc", "grahmc", "rahmc") else None,
            "n_chains": n_chains,
            "num_warmup": num_warmup,
            "num_samples": num_samples,
            "total_samples": num_samples,
            "warmup_time": warmup_time,
            "sample_time": sample_time,
            "total_time": total_time,
            "accept_rate": accept_rate,
            "rhat_max": diagnostics["rhat_max"],
            "rhat_mean": diagnostics["rhat_mean"],
            "ess_bulk_min": diagnostics["ess_bulk_min"],
            "ess_bulk_mean": diagnostics["ess_bulk_mean"],
            "ess_tail_min": diagnostics["ess_tail_min"],
            "ess_tail_mean": diagnostics["ess_tail_mean"],
            "ess_per_sample": gates["ess_per_sample"],
            "ess_per_gradient": (diagnostics["ess_bulk_min"] / n_gradients
                                 if n_gradients > 0 else 0),
            "divergence_rate": divergence_rate,
            "total_divergences": total_div,
            "n_gradients": n_gradients,
            "rhat_pass": diagnostics["rhat_max"] < 1.01,
            "ess_pass": diagnostics["ess_bulk_min"] >= MIN_ESS_QUALITY,
            "ess_tail_pass": diagnostics["ess_tail_min"] >= MIN_ESS_TAIL_QUALITY,
            "stats_pass": stats_pass,
            "z_score_max": stats_result.get("max_z"),
            "z_score_threshold": stats_result.get("threshold"),
            "usable": gates["usable"],
            "quality_pass": gates["quality_pass"],
            "is_inefficient": gates["is_inefficient"],
            "is_high_efficiency": gates["is_high_efficiency"],
            "sliced_w2": sliced_w2,
            "sliced_w2_transformed": sliced_w2_transformed,
            "convergence_trace": convergence_trace if track_convergence else None,
            # schema additions: which unconstraining reparameterization (if
            # any) produced the sampled coordinates, and the constrained-
            # coordinate z-test that gates reparam rows
            "reparam": ("log" if target.family.endswith("_unconstrained")
                        else None),
            "stats_pass_transformed": (stats_result_t["pass"]
                                       if stats_result_t else None),
            "z_score_max_transformed": (stats_result_t.get("max_z")
                                        if stats_result_t else None),
        }
        results.update(sampler_metadata)
        results["warmup_restored"] = warmup_restored
        # schema addition: which chain mesh (if any) ran this row — makes
        # multi-chip runs auditable from the results file alone
        results["mesh_devices"] = (int(mesh.devices.size)
                                   if mesh is not None else None)
        results["mass_matrix_learned"] = learn_mass_matrix
        if learn_mass_matrix and inv_mass is not None:
            results["mass_matrix_min"] = float(jnp.min(inv_mass))
            results["mass_matrix_max"] = float(jnp.max(inv_mass))
            results["mass_matrix_mean"] = float(jnp.mean(inv_mass))

        status = ("[PASS]" if results["quality_pass"]
                  else "[USABLE]" if results["usable"] else "[FAIL]")
        print(f"{status} R-hat={results['rhat_max']:.4f} "
              f"ESS={results['ess_bulk_min']:.0f}/{results['ess_tail_min']:.0f} "
              f"div={divergence_rate:.1%} "
              f"W2={sliced_w2 if sliced_w2 is None else round(sliced_w2, 4)} "
              f"({total_time:.1f}s)")
        if sampling_ckpt is not None:
            # the row is complete: the (large) partial-history checkpoint
            # is superseded by the benchmark's own resume-by-signature
            sampling_ckpt.clear()
        return results

    except Exception as e:
        import traceback
        traceback.print_exc()
        return {
            "sampler": sampler,
            "target": target.name,
            "schedule": schedule_type if is_grahmc else None,
            "dim": target.dim,
            "num_steps": num_steps,
            "tempering": int(tempering) if use_tempering else None,
            "total_samples": 0,
            "ess_bulk_min": 0.0,
            "n_gradients": 0,
            "divergence_rate": None,
            "error": str(e),
            "total_time": time.time() - start_time,
            "usable": False,
            "quality_pass": False,
        }


def run_single_smc_benchmark(
    target: TargetDistribution,
    target_name: str,
    key,
    n_particles: int = 4096,
    move_steps: int = 3,
    num_steps: int = 8,
    step_size: float = 0.4,
    base_scale: float = 2.0,
    target_rel_ess: float = 0.5,
    max_stages: int = 200,
    mesh_devices="auto",
    tune_trajectory: bool = False,
) -> Dict:
    """One annealed-SMC benchmark row: transport n_particles from
    N(0, base_scale^2 I) to the target, estimate log Z, gate the final
    population.

    SMC is a one-shot population method — no warmup phase (the move step
    size Robbins-Monro-adapts per transition inside the run, see
    samplers/smc.py), no draw count (the population IS the sample set),
    and no chains over time (so no R-hat; gate rationale in
    diagnostics/gates.py::evaluate_smc_gates). The row keeps the shared
    results schema with the non-applicable fields None and adds
    ``log_z`` / ``smc_*`` extras. Under a mesh the particle population is
    chain-sharded via parallel/fused_sharded.py::smc_run_sharded.

    Beyond-reference capability: nothing in the reference estimates
    normalizing constants (its bimodal benchmark works around
    multimodality with a split-mode init_sampler, reference
    benchmarks/targets.py:456-465).
    """
    from mcmc_tpu.samplers.smc import smc_run, systematic_resample, \
        weighted_moments

    start_time = time.time()
    print(f"\n{'=' * 70}\nSMC | {target_name} | dim={target.dim} | "
          f"P={n_particles} | moves={move_steps}x{num_steps} leapfrogs"
          f"\n{'=' * 70}")
    if target.support == "positive":
        # The geometric bridge anneals from N(0, base_scale^2 I) over R^D;
        # at small beta the mixture puts mass outside x > 0 where the
        # target is -inf, so reweighting silently discards it and the
        # log-Z estimate biases low. The log-transformed reparameterization
        # (--reparam auto / unconstrain_target) removes the constraint.
        print("  [WARN] positive-support target under a full-support "
              "Gaussian base: mass leaks outside the support at small "
              "beta. Run with --reparam auto for the unconstrained bridge.")

    mesh = _resolve_mesh(n_particles, mesh_devices)
    common = dict(
        n_particles=n_particles, dim=target.dim, step_size=step_size,
        num_steps=num_steps, move_steps=move_steps, max_stages=max_stages,
        base_scale=base_scale, target_rel_ess=target_rel_ess,
        value_and_grad_fn=target.value_and_grad_fn,
        tune_trajectory=tune_trajectory)
    key, run_key = random.split(key)
    where = (f"mesh {mesh.devices.size} devices" if mesh is not None
             else "single-device")
    print(f"[Phase 1] Annealing ({where}, adaptive schedule, "
          f"target rel-ESS {target_rel_ess})...")
    sample_start = time.time()
    try:
        if mesh is not None:
            from mcmc_tpu.parallel.fused_sharded import smc_run_sharded
            res = smc_run_sharded(run_key, target.log_prob_fn, mesh, **common)
        else:
            res = smc_run(run_key, target.log_prob_fn, **common)
        res.log_Z.block_until_ready()
        sample_time = time.time() - sample_start

        n_stages = int(res.info["n_stages"])
        ess = float(res.info["ess"])
        log_z = float(res.log_Z)
        accept_rate = float(np.asarray(
            res.info["accept"])[:n_stages].mean()) if n_stages else 0.0
        n_moves = n_stages * move_steps * n_particles
        total_div = int(res.info["n_divergences"])
        divergence_rate = total_div / max(n_moves, 1)
        # realized per-particle leapfrog count from the run itself — exact
        # for both the fixed path (stages * moves * num_steps) and the
        # ChEES-tuned jittered path (the per-stage reweight/refresh evals
        # are gradient-free or 1/L of a move's cost and are not charged,
        # matching the MCMC rows' leapfrog-only accounting)
        n_gradients = int(res.info["n_leapfrogs"]) * n_particles
        print(f"  {n_stages} stages, {int(res.info['n_resamples'])} "
              f"resamples, log_Z={log_z:.4f}, ESS={ess:.0f}, "
              f"accept={accept_rate:.3f} ({sample_time:.1f}s)")

        # Phase 2: gates on the weighted population. Mean/MCSE for the
        # z-test come from the self-normalized estimator: mcse_i =
        # sqrt(Var_w[x_i] / ESS_w) — the IS analogue of the MCMC rows'
        # mcse_mean.
        print("[Phase 2] Diagnostics + gates...")
        wmean, wcov = weighted_moments(res.particles, res.log_weights)
        wmean = np.asarray(wmean)
        mcse = np.sqrt(np.maximum(np.asarray(jnp.diag(wcov)), 0.0)
                       / max(ess, 1.0))
        stats_result = check_summary_statistics(
            {"summary": {"mean": wmean, "mcse_mean": mcse}}, target,
            significance=0.05)
        stats_pass = stats_result["pass"]
        has_true_mean = (target.true_mean is not None
                         and target.true_cov is not None)
        # Reparameterized targets: z-test the constrained coordinates too
        # (weighted moments of the transformed population vs the original
        # target's ground truth) — same gating as the MCMC rows.
        stats_result_t = None
        if (target.transform is not None
                and target.transform_true_mean is not None
                and target.transform_true_cov is not None):
            from types import SimpleNamespace
            wmean_t, wcov_t = weighted_moments(
                target.transform(res.particles), res.log_weights)
            mcse_t = np.sqrt(np.maximum(np.asarray(jnp.diag(wcov_t)), 0.0)
                             / max(ess, 1.0))
            stats_result_t = check_summary_statistics(
                {"summary": {"mean": np.asarray(wmean_t),
                             "mcse_mean": mcse_t}},
                SimpleNamespace(true_mean=target.transform_true_mean,
                                true_cov=target.transform_true_cov),
                significance=0.05)
            stats_pass = stats_pass and stats_result_t["pass"]
            has_true_mean = True
        gates = evaluate_smc_gates(ess, divergence_rate, log_z, n_particles,
                                   stats_pass, has_true_mean)

        # Phase 3: sliced W2 of the UNWEIGHTED population (one systematic
        # resample) against the target's exact sampler — same protocol as
        # the MCMC rows.
        ref_sampler = get_reference_sampler(target_name, target.dim)
        sliced_w2 = None
        sliced_w2_transformed = None
        if ref_sampler is not None or target.transform is not None:
            print("[Phase 3] Sliced W2...")
            key, r_key = random.split(key)
            idx = systematic_resample(r_key, jnp.asarray(
                np.asarray(res.log_weights)))
            flat = np.asarray(res.particles)[np.asarray(idx)]
            if ref_sampler is not None:
                key, w2_key = random.split(key)
                sliced_w2 = compute_sliced_w2(
                    flat, target_name, target.dim, n_reference=50000,
                    n_projections=500, key=w2_key)
            if (target.transform is not None
                    and target.transform_target is not None):
                key, w2t_key = random.split(key)
                sliced_w2_transformed = compute_sliced_w2(
                    target.transform(flat), target.transform_target,
                    target.dim, n_reference=50000, n_projections=500,
                    key=w2t_key)

        total_time = time.time() - start_time
        results = {
            "sampler": "smc",
            "target": target.name,
            "schedule": None,
            "dim": target.dim,
            "num_steps": num_steps,
            "n_chains": n_particles,   # the population plays the chain role
            "num_warmup": 0,
            "num_samples": n_particles,
            "total_samples": n_particles,
            "warmup_time": 0.0,
            "sample_time": sample_time,
            "total_time": total_time,
            "accept_rate": accept_rate,
            "rhat_max": None,          # no analogue — see evaluate_smc_gates
            "rhat_mean": None,
            "ess_bulk_min": ess,       # importance-sampling ESS (weights)
            "ess_bulk_mean": ess,
            "ess_tail_min": None,
            "ess_tail_mean": None,
            "ess_per_sample": gates["ess_per_sample"],
            "ess_per_gradient": ess / n_gradients if n_gradients else 0.0,
            "divergence_rate": divergence_rate,
            "total_divergences": total_div,
            "n_gradients": n_gradients,
            "rhat_pass": None,
            "ess_pass": ess >= MIN_ESS_QUALITY,
            "ess_tail_pass": None,
            "stats_pass": stats_pass,
            "z_score_max": stats_result.get("max_z"),
            "z_score_threshold": stats_result.get("threshold"),
            "usable": gates["usable"],
            "quality_pass": gates["quality_pass"],
            "is_inefficient": gates["is_inefficient"],
            "is_high_efficiency": gates["is_high_efficiency"],
            "sliced_w2": sliced_w2,
            "sliced_w2_transformed": sliced_w2_transformed,
            "convergence_trace": None,
            "reparam": ("log" if target.family.endswith("_unconstrained")
                        else None),
            "stats_pass_transformed": (stats_result_t["pass"]
                                       if stats_result_t else None),
            "z_score_max_transformed": (stats_result_t.get("max_z")
                                        if stats_result_t else None),
            # SMC-specific extras
            "log_z": log_z,
            "smc_particles": n_particles,
            "smc_stages": n_stages,
            "smc_resamples": int(res.info["n_resamples"]),
            "smc_move_steps": move_steps,
            "smc_base_scale": float(base_scale),
            "smc_target_rel_ess": float(target_rel_ess),
            "smc_tune_trajectory": bool(tune_trajectory),
            "smc_final_trajectory_length": (
                float(res.info["final_trajectory_length"])
                if tune_trajectory else None),
            "step_size": float(res.info["final_step_size"]),
            "mesh_devices": (int(mesh.devices.size)
                             if mesh is not None else None),
            "mass_matrix_learned": False,
        }
        status = ("[PASS]" if results["quality_pass"]
                  else "[USABLE]" if results["usable"] else "[FAIL]")
        print(f"{status} log_Z={log_z:.4f} ESS={ess:.0f} "
              f"div={divergence_rate:.1%} "
              f"W2={sliced_w2 if sliced_w2 is None else round(sliced_w2, 4)} "
              f"({total_time:.1f}s)")
        return results
    except Exception as e:
        import traceback
        traceback.print_exc()
        return {
            "sampler": "smc",
            "target": target.name,
            "schedule": None,
            "dim": target.dim,
            "num_steps": num_steps,
            "total_samples": 0,
            "ess_bulk_min": 0.0,
            "n_gradients": 0,
            "divergence_rate": None,
            "error": str(e),
            "total_time": time.time() - start_time,
            "usable": False,
            "quality_pass": False,
            "mass_matrix_learned": False,
        }


def run_trajectory_length_grid_search(
    sampler: str,
    target: TargetDistribution,
    target_name: str,
    key,
    n_chains: int,
    num_warmup: int,
    num_samples: int,
    schedule_type: str,
    num_steps_grid: List[int],
    learn_mass_matrix: bool = True,
    track_convergence: bool = False,
    convergence_base: float = 1.5,
    mesh_devices="auto",
    warmup_cache_dir: Optional[str] = None,
    tempering: int = 0,
    tempering_beta_min: float = 0.05,
    tempering_swap_interval: int = 1,
    tempering_ladder: str = "geometric",
) -> Dict:
    """Grid-search L; select max ESS/gradient preferring quality_pass runs;
    explicit failure record (with least-bad diagnostics) when nothing is
    usable."""
    print(f"\n{'#' * 80}\nGRID SEARCH over L = {num_steps_grid}\n{'#' * 80}")

    grid_results = []
    for L in num_steps_grid:
        key, subkey = random.split(key)
        r = run_single_benchmark_with_L(
            sampler, target, target_name, subkey, n_chains, num_warmup,
            num_samples, schedule_type, L, learn_mass_matrix,
            track_convergence, convergence_base, mesh_devices=mesh_devices,
            warmup_cache_dir=warmup_cache_dir, tempering=tempering,
            tempering_beta_min=tempering_beta_min,
            tempering_swap_interval=tempering_swap_interval,
            tempering_ladder=tempering_ladder)
        if r.get("error") is None:
            n_grad = r.get("n_gradients", r["total_samples"] * L)
            r["n_gradients"] = n_grad
            r["ess_per_gradient"] = (r["ess_bulk_min"] / n_grad
                                     if n_grad > 0 else 0)
        else:
            r["n_gradients"] = 0
            r["ess_per_gradient"] = 0
        grid_results.append(r)

    usable = [r for r in grid_results if r.get("usable", False)]

    if not usable:
        print("\nGRID SEARCH FAILED: no L produced usable samples")

        def least_bad_score(r):
            if r.get("error"):
                return (float("inf"), 0)
            return (r.get("rhat_max", float("inf")), -r.get("ess_bulk_min", 0))

        least_bad = min(grid_results, key=least_bad_score)
        failure = {
            "sampler": sampler,
            "target": target.name,
            "schedule": schedule_type if sampler in ("grahmc", "rahmc") else None,
            "dim": target.dim,
            "n_chains": n_chains,
            "grid_search_failed": True,
            "usable": False,
            "quality_pass": False,
            "error": "No trajectory length produced usable samples",
            "num_samples": num_samples,
            "num_warmup": num_warmup,
        }
        # carry all diagnostic fields from the least-bad run for post-mortems
        for field in ["num_steps", "total_samples", "n_gradients", "rhat_max",
                      "rhat_mean", "ess_bulk_min", "ess_bulk_mean",
                      "ess_tail_min", "ess_tail_mean", "ess_per_sample",
                      "ess_per_gradient", "divergence_rate",
                      "total_divergences", "accept_rate", "warmup_time",
                      "sample_time", "total_time", "sliced_w2", "stats_pass",
                      "z_score_max", "z_score_threshold", "convergence_trace",
                      "rhat_pass", "ess_pass", "ess_tail_pass",
                      "is_inefficient", "is_high_efficiency", "step_size",
                      "gamma", "steepness", "avg_tree_depth",
                      "mass_matrix_learned", "mass_matrix_min",
                      "mass_matrix_max", "mass_matrix_mean",
                      "tempering", "tempering_beta_min",
                      "tempering_swap_interval", "swap_accept_rate",
                      "replica_accept_rate", "tempering_betas",
                      "tempering_ladder", "ladder_tune_time",
                      "ladder_rounds", "ladder_initial_deviation",
                      "ladder_final_deviation", "tempering_step_sizes",
                      "reparam", "stats_pass_transformed",
                      "z_score_max_transformed", "sliced_w2_transformed"]:
            failure[field] = least_bad.get(field)
        failure["ess_bulk_min"] = least_bad.get("ess_bulk_min", 0)
        failure["grid_search_info"] = {
            "tested_L_values": num_steps_grid,
            "selected_L": None,
            "has_usable": False,
            "least_bad_L": least_bad.get("num_steps"),
            "all_results": [dict(_grid_summary(r), error=r.get("error"))
                            for r in grid_results],
        }
        return failure

    quality = [r for r in usable if r.get("quality_pass", False)]
    pool, tier = (quality, "quality_pass") if quality else (usable, "usable_only")
    best = max(pool, key=lambda r: r["ess_per_gradient"])
    selected_L = best["num_steps"]

    print(f"\nGRID SEARCH COMPLETE — best L={selected_L} "
          f"(ESS/grad={best['ess_per_gradient']:.6f}) [{tier}]")
    for r in grid_results:
        status = ("[ERROR]" if r.get("error") else
                  "[PASS]" if r.get("quality_pass") else
                  "[USABLE]" if r.get("usable") else "[FAIL]")
        print(f"  L={r['num_steps']:3d}: ESS/grad={r.get('ess_per_gradient', 0):.6f} "
              f"ESS={r.get('ess_bulk_min', 0):7.1f} "
              f"R-hat={r.get('rhat_max', 0) or 0:.4f} {status}")

    best["grid_search_info"] = {
        "tested_L_values": num_steps_grid,
        "selected_L": selected_L,
        "selection_tier": tier,
        "has_usable": True,
        "all_results": [_grid_summary(r) for r in grid_results],
    }
    return best


# ============================================================================
# Incremental save / resume
# ============================================================================

def _round_floats(obj):
    if isinstance(obj, bool):
        return obj
    if isinstance(obj, float):
        return round(obj, 4)
    if isinstance(obj, (int, str, type(None))):
        return obj
    if isinstance(obj, dict):
        return {k: _round_floats(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_round_floats(x) for x in obj]
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return round(float(obj), 4)
    if isinstance(obj, jnp.ndarray):
        return _round_floats(np.asarray(obj).tolist())
    return obj


def _config_key(row: Dict):
    """One row per (sampler, target, schedule, mass-matrix mode) is the
    results-file invariant: the remaining resume-signature fields
    (nuts backend/snapshot interval/proposal scheme, trajectory tuner)
    are run-level settings, so a second row under the same key can only
    be a stale leftover from a re-run with changed settings — a re-run
    with e.g. the other --nuts-proposal re-measures (resume signature
    differs) and REPLACES the row; use separate output dirs to compare
    schemes side by side."""
    return (row.get("sampler"), row.get("target"), row.get("schedule"),
            row.get("mass_matrix_learned"))


def _csv_cell(value):
    """One CSV cell: None and NaN are empty, everything else its str()."""
    if value is None or (isinstance(value, float) and value != value):
        return ""
    return value


def _write_csv_row(path, columns, row, header: bool):
    """Write (header=True: create with a header) or append one row in the
    pinned column order; columns the row lacks stay empty and keys outside
    the pinned order are dropped, so appends stay aligned across resumes."""
    with open(path, "w" if header else "a", newline="") as f:
        writer = csv.writer(f)
        if header:
            writer.writerow(columns)
        writer.writerow([_csv_cell(row.get(c)) for c in columns])


def save_result_incremental(result: Dict, output_dir: str, is_first: bool = False):
    """Append one result to benchmark_results.{csv,json}; the CSV column order
    is pinned in .csv_columns.json so appends stay aligned across resumes.

    The JSON (the canonical file — analysis and resume both read it) drops
    any prior row with the same _config_key before appending, so a config
    re-measured under new settings (e.g. a dense NUTS row that now resolves
    to the persistent backend) replaces its stale row instead of
    double-counting in downstream summaries. The CSV is an append-only
    mirror and may retain superseded rows mid-run."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    csv_path = out / "benchmark_results.csv"
    json_path = out / "benchmark_results.json"
    col_order_path = out / ".csv_columns.json"

    rounded = _round_floats(result)

    csv_row = copy.deepcopy(rounded)
    for k in ("grid_search_info", "convergence_trace"):
        if csv_row.get(k) is not None:
            csv_row[k] = json.dumps(csv_row[k])

    if is_first or not csv_path.exists():
        columns = list(csv_row)
        with open(col_order_path, "w") as f:
            json.dump(columns, f)
        _write_csv_row(csv_path, columns, csv_row, header=True)
    else:
        if col_order_path.exists():
            with open(col_order_path) as f:
                columns = json.load(f)
        else:
            columns = list(csv_row)
            with open(col_order_path, "w") as f:
                json.dump(columns, f)
        _write_csv_row(csv_path, columns, csv_row, header=False)

    if is_first or not json_path.exists():
        all_results = [rounded]
    else:
        with open(json_path) as f:
            all_results = json.load(f)
        key = _config_key(rounded)
        all_results = [r for r in all_results if _config_key(r) != key]
        all_results.append(rounded)
    with open(json_path, "w") as f:
        json.dump(all_results, f, indent=2)


def _resume_signature(sampler, target_name, schedule, learn_mass,
                      nuts_backend=None, nuts_steps_per_sample=None,
                      trajectory_tuner=None, nuts_proposal=None,
                      tempering=None, smc_particles=None,
                      smc_tune_trajectory=None):
    """Completed-set key for resume-by-signature.

    NUTS rows additionally key on the resolved backend and (for the
    persistent backend) the snapshot interval, so re-running a grid with a
    different --nuts-backend / --nuts-steps-per-sample re-measures instead
    of silently skipping and keeping rows from the old settings. Rows saved
    before these fields existed resolve to (None, None) and re-run.

    HMC/GRAHMC rows key on the trajectory tuner for the same reason:
    switching --trajectory-tuner between grid and chees must re-measure.
    Grid rows (and all pre-chees rows, which were grid by construction)
    resolve to None; a chees run that FELL BACK to the grid is saved with
    trajectory_tuner='chees' so the resumed chees grid doesn't re-pay the
    failed tuning attempt.
    """
    sig = (sampler, target_name, schedule, learn_mass)
    if sampler == "nuts":
        sig += (nuts_backend,
                nuts_steps_per_sample if nuts_backend == "persistent"
                else None,
                # proposal scheme only exists on the persistent machine;
                # pre-multinomial rows resolve to None == "endpoint"
                (nuts_proposal or "endpoint")
                if nuts_backend == "persistent" else None)
    elif sampler in ("hmc", "grahmc", "rahmc"):
        sig += ("chees" if trajectory_tuner == "chees" else None,
                # replica-exchange rows key on the ladder size: re-running
                # with a different --tempering re-measures instead of
                # skipping. Untempered rows (and all pre-tempering rows)
                # resolve to None.
                int(tempering) if tempering and int(tempering) > 1 else None)
    elif sampler == "smc":
        # population size and the trajectory tuner are the knobs that
        # change what an SMC row measures at fixed seed: re-running with a
        # different --smc-particles / --smc-tune-trajectory re-measures
        # instead of skipping (pre-tuner rows resolve to None == fixed)
        sig += (int(smc_particles) if smc_particles else None,
                "chees" if smc_tune_trajectory else None)
    return sig


def run_all_benchmarks(
    samplers: List[str],
    targets: List[str],
    grahmc_schedules: List[str],
    dim: int,
    n_chains: int,
    num_warmup: int,
    num_samples: int,
    seed: int,
    output_dir: str,
    num_steps_grid: Optional[List[int]] = None,
    mass_matrix_modes: Optional[List[bool]] = None,
    track_convergence: bool = False,
    convergence_base: float = 1.5,
    mesh_devices="auto",
    nuts_backend: str = "auto",
    warmup_cache: bool = True,
    nuts_steps_per_sample: int = 64,
    trajectory_tuner: str = "grid",
    nuts_proposal: str = "endpoint",
    gamma_tuner: str = "grid",
    tempering: int = 0,
    tempering_beta_min: float = 0.05,
    tempering_swap_interval: int = 1,
    tempering_ladder: str = "geometric",
    smc_particles: int = 4096,
    smc_move_steps: int = 3,
    smc_num_steps: int = 8,
    smc_step_size: float = 0.4,
    smc_base_scale: float = 2.0,
    smc_rel_ess: float = 0.5,
    smc_max_stages: int = 200,
    smc_tune_trajectory: bool = False,
    reparam: str = "off",
):
    """Iterate target x sampler x mass-mode (x schedule for GRAHMC) with
    resume-by-signature and incremental saving. Returns the result rows
    (a list of dicts, the contents of benchmark_results.json).

    warmup_cache: checkpoint Phase-1 warmup products per configuration
    under `<output_dir>/.warmup_cache_seed<seed>/` so an interrupted grid
    re-run (same seed) skips warmups it already completed.

    trajectory_tuner: 'grid' (reference parity: one full pipeline per L in
    num_steps_grid) or 'chees' (ONE warmup adapts the trajectory length
    cross-chain, then jittered sampling; falls back to the grid when the
    tuner reports a trajectory-cap runaway — flat-tailed targets).

    reparam: 'off' (reference parity — sample every target in its natural
    coordinates) or 'auto' (constrained-support targets are swapped for
    their log-transformed reparameterization via unconstrain_target; rows
    are saved under the transformed target name with reparam='log' and
    additionally gate on the constrained-coordinate z-test)."""
    import jax

    if reparam not in ("off", "auto"):
        raise ValueError(f"reparam must be 'off' or 'auto', got {reparam!r}")

    if tempering and tempering > 1 and trajectory_tuner == "chees":
        raise ValueError(
            "--tempering composes with the fixed-L pipeline, not the ChEES "
            "tuner (the criterion would adapt to the cold replica only); "
            "drop one of the two flags")

    # Reference parity: the CLI enables x64 on the CPU only. On an
    # accelerator float32 stays the policy (mcmc_tpu.precision), validated
    # by the statistical gates.
    if jax.default_backend() == "cpu":
        jax.config.update("jax_enable_x64", True)
    key = random.PRNGKey(seed)
    Path(output_dir).mkdir(parents=True, exist_ok=True)
    if num_steps_grid is None:
        num_steps_grid = DEFAULT_L_GRID
    if mass_matrix_modes is None:
        mass_matrix_modes = [True]

    warmup_cache_dir = (str(Path(output_dir) / f".warmup_cache_seed{seed}")
                        if warmup_cache else None)

    json_path = Path(output_dir) / "benchmark_results.json"
    if json_path.exists():
        with open(json_path) as f:
            all_results = json.load(f)
        completed = {
            _resume_signature(r.get("sampler"), r.get("target"),
                              r.get("schedule"), r.get("mass_matrix_learned"),
                              r.get("nuts_backend"),
                              r.get("nuts_steps_per_sample"),
                              r.get("trajectory_tuner"),
                              r.get("nuts_proposal"),
                              r.get("tempering"),
                              r.get("smc_particles"),
                              r.get("smc_tune_trajectory"))
            for r in all_results}
        print(f"RESUMING: {len(all_results)} existing results, skipping "
              f"{len(completed)} completed configurations")
        is_first = False
    else:
        all_results, completed, is_first = [], set(), True

    for target_name in targets:
        print(f"\n{'#' * 80}\n# TARGET: {target_name} (dim={dim})\n{'#' * 80}")
        target = get_target(target_name, dim=dim)
        if reparam == "auto" and target.support != "real":
            # sample the unconstrained reparameterization instead; the row
            # is keyed/saved under the transformed name (resume signatures
            # of the natural-coordinate rows stay untouched) and the
            # transformed-coordinate W2/z-test report against the ORIGINAL
            # target's ground truth
            from mcmc_tpu.targets import unconstrain_target
            target = unconstrain_target(target, registry_name=target_name)
            target_name = f"{target_name}_unconstrained"
            print(f"  [reparam] sampling {target.name} "
                  f"(log-transformed, support now R^D)")

        for sampler in samplers:
            if sampler == "smc":
                # SMC has no warmup phase, mass matrix, or friction
                # schedule — one row per (target, population size)
                sig = _resume_signature(
                    "smc", target.name, None, False,
                    smc_particles=smc_particles,
                    smc_tune_trajectory=smc_tune_trajectory)
                if sig in completed:
                    print(f"  [SKIP] {sig} (already completed)")
                    continue
                key, subkey = random.split(key)
                result = run_single_smc_benchmark(
                    target, target_name, subkey,
                    n_particles=smc_particles, move_steps=smc_move_steps,
                    num_steps=smc_num_steps, step_size=smc_step_size,
                    base_scale=smc_base_scale, target_rel_ess=smc_rel_ess,
                    max_stages=smc_max_stages, mesh_devices=mesh_devices,
                    tune_trajectory=smc_tune_trajectory)
                ck = _config_key(result)
                all_results = [r for r in all_results
                               if _config_key(r) != ck]
                all_results.append(result)
                save_result_incremental(result, output_dir,
                                        is_first=is_first)
                is_first = False
                continue
            for learn_mass in mass_matrix_modes:
                schedules = (grahmc_schedules if sampler in ("grahmc", "rahmc")
                             else [None])
                for schedule in schedules:
                    # Effective trajectory tuner for THIS configuration —
                    # decided before the resume signature so a chees run's
                    # completed-set key matches what its rows were saved
                    # under (fallback rows included, see _resume_signature).
                    use_chees_tuner = (trajectory_tuner == "chees"
                                       and sampler in ("grahmc", "rahmc",
                                                       "hmc"))
                    if sampler == "nuts":
                        resolved_nuts = _resolve_nuts_backend(nuts_backend,
                                                              target)
                        sig = _resume_signature(
                            sampler, target.name, schedule, learn_mass,
                            resolved_nuts, nuts_steps_per_sample,
                            nuts_proposal=nuts_proposal)
                    else:
                        sig = _resume_signature(
                            sampler, target.name, schedule, learn_mass,
                            trajectory_tuner=("chees" if use_chees_tuner
                                              else None),
                            tempering=tempering)
                    if sig in completed:
                        print(f"  [SKIP] {sig} (already completed)")
                        continue
                    key, subkey = random.split(key)
                    if sampler in ("grahmc", "rahmc", "hmc"):
                        result = None
                        chees_fell_back = False
                        if use_chees_tuner:
                            key, chees_key = random.split(key)
                            result = run_single_benchmark_with_L(
                                sampler, target, target_name, chees_key,
                                n_chains, num_warmup, num_samples,
                                schedule or "constant", 0, learn_mass,
                                track_convergence, convergence_base,
                                mesh_devices=mesh_devices,
                                warmup_cache_dir=warmup_cache_dir,
                                trajectory_tuner="chees",
                                gamma_tuner=gamma_tuner)
                            if result.get("chees_cap_hit"):
                                print("  [chees] trajectory cap hit "
                                      "(criterion runaway on this target) "
                                      "— falling back to the L grid search")
                                result = None
                                chees_fell_back = True
                        if result is None:
                            result = run_trajectory_length_grid_search(
                                sampler, target, target_name, subkey,
                                n_chains, num_warmup, num_samples,
                                schedule or "constant", num_steps_grid,
                                learn_mass, track_convergence,
                                convergence_base, mesh_devices=mesh_devices,
                                warmup_cache_dir=warmup_cache_dir,
                                tempering=tempering,
                                tempering_beta_min=tempering_beta_min,
                                tempering_swap_interval=tempering_swap_interval,
                                tempering_ladder=tempering_ladder)
                            if chees_fell_back:
                                # resume key parity: a chees run that fell
                                # back must be found under the chees
                                # signature, not re-pay the failed tuning
                                result["trajectory_tuner"] = "chees"
                                result["chees_fell_back"] = True
                    else:
                        result = run_single_benchmark_with_L(
                            sampler, target, target_name, subkey, n_chains,
                            num_warmup, num_samples, schedule or "constant",
                            20, learn_mass, mesh_devices=mesh_devices,
                            nuts_backend=nuts_backend,
                            warmup_cache_dir=warmup_cache_dir,
                            nuts_steps_per_sample=nuts_steps_per_sample,
                            nuts_proposal=nuts_proposal)
                    ck = _config_key(result)
                    all_results = [r for r in all_results
                                   if _config_key(r) != ck]
                    all_results.append(result)
                    save_result_incremental(result, output_dir, is_first=is_first)
                    is_first = False

    print(f"\n[OK] results saved incrementally to {output_dir}/"
          f"benchmark_results.{{csv,json}} ({len(all_results)} experiments)")
    return all_results


def _row_name(row):
    sched = row.get("schedule")
    return row["sampler"] + (f"-{sched}" if isinstance(sched, str) else "")


def print_summary(rows):
    """Print pass/usable counts, failure analysis, and efficiency rankings
    for the result rows run_all_benchmarks returns."""
    n = len(rows)
    if n == 0:
        print("No results.")
        return

    def counts(sub):
        return (sum(bool(r.get("quality_pass")) for r in sub),
                sum(bool(r.get("usable")) for r in sub))

    print(f"\n{'=' * 80}\nBENCHMARK SUMMARY\n{'=' * 80}")
    passed, usable = counts(rows)
    print(f"Total experiments: {n}")
    print(f"High quality: {passed}/{n} ({100 * passed / n:.1f}%)")
    print(f"Usable: {usable}/{n} ({100 * usable / n:.1f}%)")
    print(f"Failed: {n - usable}/{n}")

    for field, label, width in (("sampler", "By sampler", 10),
                                ("target", "By target", 30)):
        print(f"\n{label}:")
        for value in dict.fromkeys(r.get(field) for r in rows):
            sub = [r for r in rows if r.get(field) == value]
            p, u = counts(sub)
            print(f"  {str(value):{width}s}: pass={p}/{len(sub)}, "
                  f"usable={u}/{len(sub)}")

    for row in rows:
        if row.get("grid_search_failed") is True:
            print(f"  GRID FAILURE: {_row_name(row)} on {row['target']} "
                  f"(best L tried: {row.get('num_steps')})")

    top = sorted((r for r in rows if r.get("usable") is True
                  and r.get("ess_per_gradient") is not None),
                 key=lambda r: r["ess_per_gradient"], reverse=True)[:10]
    if top:
        print("\nTop 10 by ESS/gradient (usable only):")
        for row in top:
            rhat = row.get("rhat_max")
            # SMC rows carry rhat_max=None (no analogue)
            rhat_s = f"{rhat:.4f}" if rhat is not None and np.isfinite(
                np.float64(rhat)) else "n/a"
            print(f"  {_row_name(row):<25s} {row['target']:<25s} "
                  f"{row['ess_per_gradient']:.6f} "
                  f"(ESS={row.get('ess_bulk_min') or 0:.0f}, "
                  f"R-hat={rhat_s})")
