"""MCMC benchmark CLI (flag-and-schema parity with the reference runner).

Usage:
    python run_benchmarks.py --dim 20 --targets standard_normal neals_funnel
    python run_benchmarks.py --dim 20 --all-targets --output-dir results
    python run_benchmarks.py --all-targets --mass-matrix-mode no-mass

Flags, defaults, and the benchmark_results.{csv,json} output schema match the
reference run_benchmarks.py:1346-1390; the backend is the batched JAX
mcmc_tpu stack (on-device warmup scans, analytic gradients, real divergence
rates, the fused trajectory kernel on a GPU).
"""

import argparse

from mcmc_tpu.benchmark import run_all_benchmarks, print_summary, ALL_TARGET_NAMES
from mcmc_tpu.utils import enable_compilation_cache


def _positive_int(text):
    value = int(text)
    if value <= 0:
        raise argparse.ArgumentTypeError(f"must be a positive integer, got {value}")
    return value


def main():
    # Persistent XLA compilation cache: programs compile once per (shape,
    # program) — cache them across CLI invocations so repeat benchmark runs
    # skip straight to execution. Opt out with JAX_COMPILATION_CACHE_DIR=
    # (set to empty).
    enable_compilation_cache()
    parser = argparse.ArgumentParser(
        description="Run MCMC benchmarks with adaptive warmup")

    parser.add_argument("--targets", nargs="+", default=None,
                        help="List of targets to benchmark")
    parser.add_argument("--all-targets", action="store_true",
                        help="Run all available targets")
    parser.add_argument("--samplers", nargs="+",
                        default=["rwmh", "hmc", "nuts", "grahmc"],
                        help="List of samplers to benchmark (rwmh, hmc, "
                        "nuts, grahmc; plus 'smc' — annealed SMC with "
                        "log-Z evidence estimation, configured by the "
                        "--smc-* flags)")
    parser.add_argument("--schedules", nargs="+",
                        default=["constant", "tanh", "sigmoid", "linear", "sine"],
                        help="GRAHMC friction schedules to test")
    parser.add_argument("--dim", type=int, default=10,
                        help="Dimensionality of targets")
    parser.add_argument("--n-chains", type=int, default=4,
                        help="Number of parallel chains")
    parser.add_argument("--num-warmup", type=int, default=2500,
                        help="Warmup steps (500 exploration + windows + 125 cooldown)")
    parser.add_argument("--num-samples", type=int, default=None,
                        help="Samples to collect (default: 10000)")
    parser.add_argument("--num-steps-grid", nargs="+", type=int, default=None,
                        help="Grid of trajectory lengths for HMC/GRAHMC")
    parser.add_argument("--mass-matrix-mode", type=str,
                        choices=["mass", "no-mass", "both", "dense"],
                        default="mass",
                        help="Mass matrix: learn (diagonal, reference "
                        "parity), identity, both, or 'dense' (full "
                        "covariance metric — beyond-reference, Stan's "
                        "dense_e; runs in the fused trajectory kernel too)")
    parser.add_argument("--track-convergence", action="store_true",
                        help="Track W2 at log-spaced checkpoints")
    parser.add_argument("--convergence-base", type=float, default=1.5,
                        help="Log-spacing base for checkpoints")
    parser.add_argument("--output-dir", type=str, default="benchmark_results",
                        help="Directory to save results")
    parser.add_argument("--seed", type=int, default=42, help="Random seed")
    parser.add_argument("--nuts-backend", type=str, default="auto",
                        choices=["auto", "classic", "persistent"],
                        help="NUTS execution path: 'auto' (default — "
                        "classic until a GPU cell decides the rule), "
                        "'classic' (reference lockstep tree doubling), or "
                        "'persistent' (the asynchronous "
                        "fixed-interval-snapshot machine)")
    parser.add_argument("--mesh", type=str, default="auto",
                        help="Chain-shard over devices: 'auto' (all local devices when >1), an integer device count, or 'off'")
    parser.add_argument("--nuts-steps-per-sample", type=_positive_int, default=64,
                        help="Persistent-NUTS snapshot interval: global "
                        "leapfrog iterations of the asynchronous machine "
                        "between collected draws (ignored by the classic "
                        "backend)")
    parser.add_argument("--nuts-proposal", type=str, default="endpoint",
                        choices=["endpoint", "multinomial"],
                        help="Persistent-NUTS proposal scheme: 'endpoint' "
                        "(default — reference parity: subtree validity at "
                        "endpoints only, measurably ~3%% underdispersed) or "
                        "'multinomial' (per-leaf progressive weighting with "
                        "the full iterative sub-U-turn check set — Stan "
                        "semantics, recovers exact marginals; ignored by "
                        "the classic backend)")
    parser.add_argument("--trajectory-tuner", type=str, default="grid",
                        choices=["grid", "chees"],
                        help="Trajectory-length selection for HMC/GRAHMC: "
                        "'grid' (reference parity — one full pipeline per L "
                        "in --num-steps-grid) or 'chees' (cross-chain ChEES "
                        "adaptation: ONE warmup tunes T jointly with step/"
                        "mass, then jittered-trajectory sampling; "
                        "automatically falls back to the grid when the "
                        "criterion runs away on flat-tailed targets)")
    parser.add_argument("--gamma-tuner", type=str, default="grid",
                        choices=["grid", "joint"],
                        help="GRAHMC friction selection under "
                        "--trajectory-tuner chees: 'grid' (ChEES warmup "
                        "then the separate sequential ESJD grid phase — "
                        "reference contract) or 'joint' (SPSA on log gamma "
                        "against the acceptance-weighted sphered ESJD "
                        "INSIDE the same warmup: one phase produces step, "
                        "mass, T and gamma; falls back to the grid when "
                        "the iterate pins at a clip bound). Ignored for "
                        "other samplers/tuners")
    parser.add_argument("--tempering", type=int, default=0,
                        help="Parallel tempering for HMC/GRAHMC: run K > 1 "
                        "replica-exchange rungs (geometric inverse-"
                        "temperature ladder; samplers/tempered.py) over the "
                        "shared transition and emit the cold replica's "
                        "draws. The standard remedy for multimodal targets "
                        "(e.g. gaussian_mixture) that plain trajectories "
                        "cannot cross. 0/1 (default) disables; ignored by "
                        "RWMH/NUTS rows; n_gradients counts all K replicas")
    parser.add_argument("--tempering-beta-min", type=float, default=0.05,
                        help="Hottest rung's inverse temperature for "
                        "--tempering's geometric ladder (default 0.05)")
    parser.add_argument("--tempering-swap-interval", type=int, default=1,
                        help="Transitions between replica-exchange attempts "
                        "(default 1 = every transition; even/odd pair "
                        "phases alternate)")
    parser.add_argument("--tempering-ladder", default="geometric",
                        choices=["geometric", "adaptive"],
                        help="'adaptive' inserts a Phase-1b ladder tuning "
                        "loop (tuning/ladder.py): Robbins-Monro on the "
                        "ladder's log-spacings drives every adjacent pair "
                        "to the optimal 0.234 swap acceptance before "
                        "sampling (short tempered bursts; one compiled "
                        "executable — betas are traced). Default keeps "
                        "the fixed geometric ladder")
    parser.add_argument("--smc-particles", type=int, default=4096,
                        help="Population size for '--samplers smc' rows "
                        "(annealed SMC with log-Z evidence estimation, "
                        "samplers/smc.py). Must divide by the mesh size "
                        "when sharded (default 4096)")
    parser.add_argument("--smc-move-steps", type=int, default=3,
                        help="MCMC move transitions per SMC annealing stage "
                        "(default 3)")
    parser.add_argument("--smc-num-steps", type=int, default=8,
                        help="Leapfrog steps per SMC move transition "
                        "(default 8; the step size Robbins-Monro-adapts "
                        "per transition toward 0.65 acceptance)")
    parser.add_argument("--smc-base-scale", type=float, default=2.0,
                        help="Std of the N(0, s^2 I) base distribution the "
                        "SMC bridge starts from (default 2.0)")
    parser.add_argument("--smc-tune-trajectory", action="store_true",
                        help="Adapt the SMC move trajectory length with "
                        "the ChEES criterion on the particle population "
                        "(jittered dynamic-length moves; Devlin et al. "
                        "2025 composition). --smc-num-steps then only "
                        "sets the initial length")
    parser.add_argument("--smc-rel-ess", type=float, default=0.5,
                        help="Adaptive-schedule target: each temperature "
                        "step is chosen so the reweight's conditional "
                        "relative ESS equals this (default 0.5)")
    parser.add_argument("--reparam", type=str, default="off",
                        choices=["auto", "off"],
                        help="Unconstraining reparameterization: 'auto' "
                        "samples constrained-support targets (log_gamma) "
                        "in log-transformed coordinates with the Jacobian "
                        "term (Stan's transform layer; targets/"
                        "unconstrain_target) — divergences at the support "
                        "boundary vanish and rows additionally gate on a "
                        "z-test of the back-transformed draws against the "
                        "original moments. Default 'off' = reference "
                        "parity (natural coordinates). Rows are saved "
                        "under '<target>_log' names with reparam='log', "
                        "so both arms can live in one results dir")
    parser.add_argument("--no-warmup-cache", action="store_true",
                        help="Disable per-configuration warmup checkpoints "
                        "(<output-dir>/.warmup_cache_seed<seed>/); with the "
                        "cache on, an interrupted run re-executed with the "
                        "same seed restores tuned step/metric/positions "
                        "instead of re-paying each 2500-step warmup")

    args = parser.parse_args()

    if args.all_targets:
        targets = list(ALL_TARGET_NAMES)
    elif args.targets:
        targets = args.targets
    else:
        print("Error: Must specify --targets or --all-targets")
        return

    mass_modes = {"mass": [True], "no-mass": [False],
                  "both": [True, False],
                  "dense": ["dense"]}[args.mass_matrix_mode]
    num_samples = args.num_samples if args.num_samples is not None else 10000

    print("=" * 80)
    print("MCMC BENCHMARK SUITE (fixed budget, adaptive warmup)")
    print("=" * 80)
    print(f"Targets: {', '.join(targets)}")
    print(f"Samplers: {', '.join(args.samplers)}")
    print(f"dim={args.dim} chains={args.n_chains} warmup={args.num_warmup} "
          f"samples={num_samples}")
    print(f"Mass matrix: {args.mass_matrix_mode} | Output: {args.output_dir}")
    print("=" * 80)

    rows = run_all_benchmarks(
        samplers=args.samplers,
        targets=targets,
        grahmc_schedules=args.schedules,
        dim=args.dim,
        n_chains=args.n_chains,
        num_warmup=args.num_warmup,
        num_samples=num_samples,
        seed=args.seed,
        output_dir=args.output_dir,
        num_steps_grid=args.num_steps_grid,
        mass_matrix_modes=mass_modes,
        track_convergence=args.track_convergence,
        convergence_base=args.convergence_base,
        mesh_devices=(args.mesh if args.mesh in ('auto', 'off')
                      else int(args.mesh)),
        warmup_cache=not args.no_warmup_cache,
        nuts_steps_per_sample=args.nuts_steps_per_sample,
        nuts_backend=args.nuts_backend,
        nuts_proposal=args.nuts_proposal,
        trajectory_tuner=args.trajectory_tuner,
        gamma_tuner=args.gamma_tuner,
        tempering=args.tempering,
        tempering_beta_min=args.tempering_beta_min,
        tempering_swap_interval=args.tempering_swap_interval,
        tempering_ladder=args.tempering_ladder,
        smc_particles=args.smc_particles,
        smc_move_steps=args.smc_move_steps,
        smc_num_steps=args.smc_num_steps,
        smc_base_scale=args.smc_base_scale,
        smc_rel_ess=args.smc_rel_ess,
        smc_tune_trajectory=args.smc_tune_trajectory,
        reparam=args.reparam,
    )
    print_summary(rows)


if __name__ == "__main__":
    main()
