#!/usr/bin/env python
"""Parallel tempering walkthrough: crossing a multimodal barrier.

Demonstrates the capability the reference lacks entirely (its bimodal
gaussian_mixture benchmark dodges the failure with a split-mode
init_sampler, reference benchmarks/targets.py:456-465): ALL chains start
in ONE mode of a bimodal target; plain HMC stays stuck there, while the
replica-exchange ladder (samplers/tempered.py) crosses freely. The
adaptive ladder tuner (tuning/ladder.py) then re-spaces the inverse
temperatures toward uniform 0.234 swap acceptance and learns per-rung
step sizes before the production run.

Equivalent CLI: python run_benchmarks.py --tempering K
                --tempering-ladder adaptive ...

Usage: python examples/tempering.py [--separation 10] [--dim 6]
       [--chains 32] [--n-temps 6] [--out examples_out]
"""

import argparse
import os

import numpy as np

import jax
from jax import random


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--separation", type=float, default=10.0)
    parser.add_argument("--dim", type=int, default=6)
    parser.add_argument("--chains", type=int, default=32)
    parser.add_argument("--n-temps", type=int, default=6)
    parser.add_argument("--num-samples", type=int, default=800)
    parser.add_argument("--ladder-rounds", type=int, default=10)
    parser.add_argument("--out", type=str, default="examples_out")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if jax.default_backend() == "cpu":
        jax.config.update("jax_enable_x64", True)
    os.makedirs(args.out, exist_ok=True)

    import jax.numpy as jnp

    from mcmc_tpu.samplers import hmc_run, tempered_run
    from mcmc_tpu.targets import gaussian_mixture
    from mcmc_tpu.tuning.ladder import tune_ladder

    target = gaussian_mixture(args.dim, separation=args.separation)
    half_sep = args.separation / 2.0
    true_var0 = 1.0 + half_sep ** 2
    key = random.PRNGKey(args.seed)
    k_init, k_plain, k_ladder, k_sample = random.split(key, 4)

    # everyone starts in the LEFT mode — no split-mode crutch
    init = random.normal(k_init, (args.chains, args.dim)) * 0.3
    init = init.at[:, 0].add(-half_sep)

    print(f"[1/4] Plain HMC, all chains in the left mode "
          f"(barrier: {half_sep:.0f} sigma) ...")
    rp = hmc_run(k_plain, target.log_prob_fn, init, step_size=0.3,
                 num_steps=16, num_samples=args.num_samples, burn_in=200,
                 value_and_grad_fn=target.value_and_grad_fn)
    x0 = np.asarray(rp.samples)[..., 0].reshape(-1)
    print(f"      mean x0 = {x0.mean():+.2f} (true 0), "
          f"right-mode fraction = {(x0 > 0).mean():.3f} (true 0.5)")

    print(f"[2/4] Adapting the {args.n_temps}-rung ladder "
          f"({args.ladder_rounds} tempered bursts) ...")
    calls = [0]

    def burst(betas, steps, rep):
        k = random.fold_in(k_ladder, calls[0])
        calls[0] += 1
        r = tempered_run(k, target.log_prob_fn, init,
                         step_size=jnp.asarray(steps), num_steps=16,
                         num_samples=24, betas=jnp.asarray(betas),
                         init_replica_position=rep,
                         value_and_grad_fn=target.value_and_grad_fn)
        return (np.asarray(r.info["swap_accept_rate"]),
                np.asarray(r.info["swap_attempts"]),
                np.asarray(r.info["replica_accept_rate"]),
                r.info["replica_final_positions"])

    betas, info = tune_ladder(burst, args.n_temps, beta_min_init=0.01,
                              n_rounds=args.ladder_rounds,
                              step_size=0.3, target_accept=0.65,
                              verbose=False)
    print(f"      mean|A-0.234|: {info['initial_deviation']:.3f} -> "
          f"{info['final_deviation']:.3f}")
    print(f"      betas = {[round(float(b), 4) for b in betas]}")
    print(f"      steps = {[round(float(s), 3) for s in info['step_sizes']]}")

    print(f"[3/4] Tempered sampling ({args.num_samples} draws, tuned "
          "ladder, continuing from the burst-equilibrated replicas) ...")
    rt = tempered_run(
        k_sample, target.log_prob_fn, init,
        step_size=jnp.asarray(info["step_sizes"]), num_steps=16,
        num_samples=args.num_samples, betas=jnp.asarray(betas),
        init_replica_position=info["replica_final_positions"],
        value_and_grad_fn=target.value_and_grad_fn)
    x0t = np.asarray(rt.samples)[..., 0].reshape(-1)
    sw = np.asarray(rt.info["swap_accept_rate"])
    print(f"      mean x0 = {x0t.mean():+.2f}, right-mode fraction = "
          f"{(x0t > 0).mean():.3f}, Var[x0] = {x0t.var():.1f} "
          f"(true {true_var0:.0f})")
    print(f"      swap acceptance per pair: "
          f"{[round(float(s), 2) for s in sw]}")

    print("[4/4] Histogram ...")
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(1, 2, figsize=(9, 3), sharey=True)
        ax[0].hist(x0, bins=60, density=True, color="tab:red")
        ax[0].set_title("plain HMC (stuck)")
        ax[1].hist(x0t, bins=60, density=True, color="tab:blue")
        ax[1].set_title("tempered (tuned ladder)")
        for a in ax:
            a.set_xlabel("x0")
        fig.tight_layout()
        path = os.path.join(args.out, "tempering_modes.png")
        fig.savefig(path, dpi=100)
        print(f"      wrote {path}")
    except Exception as e:                      # matplotlib optional
        print(f"      plot skipped: {e}")


if __name__ == "__main__":
    main()
