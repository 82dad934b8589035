#!/usr/bin/env python
"""ChEES trajectory-length adaptation walkthrough.

Demonstrates the batched alternative to the reference's 7-run L grid
search (reference run_benchmarks.py:1055-1056): ONE warmup jointly adapts
step size (dual averaging), diagonal mass matrix (Welford windows) and
trajectory length (the ChEES criterion of Hoffman, Radul & Sountsov 2021,
ascended with Adam on log T), then sampling runs quasirandomly jittered
trajectories around the tuned length. Produces the adaptation-history plot
and a posterior-moment check.

Equivalent CLI: python run_benchmarks.py --trajectory-tuner chees ...

Usage: python examples/chees_tuning.py [--target neals_funnel_noncentered]
       [--dim 10] [--chains 64] [--out examples_out]
"""

import argparse
import os

import numpy as np

import jax
from jax import random


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--target", type=str,
                        default="neals_funnel_noncentered")
    parser.add_argument("--dim", type=int, default=10)
    parser.add_argument("--chains", type=int, default=64)
    parser.add_argument("--num-warmup", type=int, default=800)
    parser.add_argument("--num-samples", type=int, default=1000)
    parser.add_argument("--out", type=str, default="examples_out")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if jax.default_backend() == "cpu":
        jax.config.update("jax_enable_x64", True)
    os.makedirs(args.out, exist_ok=True)

    from mcmc_tpu import get_target
    from mcmc_tpu.diagnostics import compute_diagnostics
    from mcmc_tpu.tuning.chees import run_chees_warmup, chees_run
    from mcmc_tpu.tuning.plots import plot_chees_history

    target = get_target(args.target, dim=args.dim)
    key = random.PRNGKey(args.seed)
    k_init, k_warm, k_sample = random.split(key, 3)
    if target.init_sampler is not None:
        init = target.init_sampler(k_init, args.chains)
    else:
        init = random.normal(k_init, (args.chains, target.dim)) * 0.5

    print(f"[1/3] ChEES warmup ({args.num_warmup} steps, "
          f"{args.chains} chains) ...")
    step_size, inv_mass, position, info = run_chees_warmup(
        "hmc", target.log_prob_fn, None, init, k_warm,
        num_warmup=args.num_warmup,
        value_and_grad_fn=target.value_and_grad_fn, verbose=True)
    print(f"      tuned: T={info['trajectory_length']:.3f} "
          f"step={step_size:.4f} -> L~{info['num_steps']} "
          f"(cap hit: {info['max_steps_cap_hit']})")
    plot_chees_history(info, "HMC",
                       os.path.join(args.out, "chees_history.png"))

    print(f"[2/3] Jittered sampling ({args.num_samples} draws) ...")
    res = chees_run(
        k_sample, target.log_prob_fn, position, step_size,
        info["trajectory_length"], args.num_samples, burn_in=100,
        inv_mass_matrix=inv_mass,
        value_and_grad_fn=target.value_and_grad_fn)
    print(f"      accept={float(res.accept_rate.mean()):.3f} "
          f"mean leapfrogs/draw={res.info['mean_num_steps']:.1f} "
          f"total grads={res.info['total_leapfrogs'] * args.chains:,}")

    print("[3/3] Diagnostics ...")
    diag = compute_diagnostics(res.samples)
    print(f"      R-hat max={diag['rhat_max']:.4f} "
          f"bulk-ESS min={diag['ess_bulk_min']:.0f}")
    s = np.asarray(res.samples).reshape(-1, target.dim)
    if target.true_mean is not None:
        bias = float(np.max(np.abs(s.mean(0) - np.asarray(target.true_mean))))
        print(f"      max |mean bias| = {bias:.4f}")


if __name__ == "__main__":
    main()
