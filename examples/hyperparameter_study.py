#!/usr/bin/env python
"""Hyperparameter grid studies on the standard normal target.

Script replacement for the reference's run.ipynb (SURVEY.md N1): RWMH
proposal-scale sweep against the Roberts & Rosenthal optimum 2.38/sqrt(d),
and an HMC (step size x trajectory length) efficiency map. These studies
inform the framework's default grids.

Usage: python examples/hyperparameter_study.py [--dim 10] [--out examples_out]
"""

import argparse
import os

import numpy as np

import jax
import jax.numpy as jnp
from jax import random


def rwmh_scale_sweep(target, key, n_chains=16, num_samples=2000, out_dir="."):
    """ESS/sample vs proposal scale; the peak should sit near 2.38/sqrt(d)."""
    from mcmc_tpu.samplers import rwmh_run
    from mcmc_tpu.diagnostics import ess_bulk

    d = target.dim
    optimal = 2.38 / np.sqrt(d)
    scales = optimal * np.array([0.125, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0])

    rows = []
    for scale in scales:
        key, k1, k2 = random.split(key, 3)
        init = random.normal(k1, (n_chains, d))
        res = rwmh_run(k2, target.log_prob_fn, init, num_samples=num_samples,
                       scale=float(scale), burn_in=500)
        ess = float(jnp.min(ess_bulk(res.samples)))
        # ess_bulk pools all chains; normalize per chain-draw so the axis
        # is comparable with the HMC map's per-gradient normalization.
        rows.append((float(scale), ess / (num_samples * n_chains),
                     float(res.accept_rate.mean())))
        print(f"  scale={scale:.3f}: ESS/sample={rows[-1][1]:.4f} "
              f"accept={rows[-1][2]:.3f}")

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.5))
    xs, effs, accs = zip(*rows)
    ax1.semilogx(xs, effs, "o-")
    ax1.axvline(optimal, color="red", ls="--", label=f"2.38/sqrt(d)={optimal:.3f}")
    ax1.set_xlabel("proposal scale")
    ax1.set_ylabel("min bulk ESS / sample")
    ax1.set_title(f"RWMH efficiency vs scale ({d}D standard normal)")
    ax1.legend(); ax1.grid(alpha=0.3)
    ax2.semilogx(xs, accs, "o-", color="green")
    ax2.axhline(0.234, color="red", ls="--", label="0.234 optimum")
    ax2.set_xlabel("proposal scale")
    ax2.set_ylabel("acceptance rate")
    ax2.legend(); ax2.grid(alpha=0.3)
    path = os.path.join(out_dir, "rwmh_scale_sweep.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    print(f"  saved {path}")
    return rows


def hmc_step_length_map(target, key, n_chains=16, num_samples=1000, out_dir="."):
    """ESS/gradient over (step size, L) — shows resonance valleys on the
    harmonic target and motivates the default L grid."""
    from mcmc_tpu.samplers import hmc_run
    from mcmc_tpu.diagnostics import ess_bulk

    d = target.dim
    steps = [0.1, 0.2, 0.4, 0.8]
    Ls = [2, 4, 8, 16, 32]
    grid = np.zeros((len(steps), len(Ls)))
    for i, eps in enumerate(steps):
        for j, L in enumerate(Ls):
            key, k1, k2 = random.split(key, 3)
            init = random.normal(k1, (n_chains, d))
            res = hmc_run(k2, target.log_prob_fn, init, step_size=eps,
                          num_steps=L, num_samples=num_samples, burn_in=200,
                          value_and_grad_fn=target.value_and_grad_fn)
            ess = float(jnp.min(ess_bulk(res.samples)))
            grid[i, j] = ess / (num_samples * L * n_chains)
        print(f"  eps={eps}: ESS/grad = "
              + " ".join(f"{v:.5f}" for v in grid[i]))

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(7, 5))
    im = ax.imshow(grid, cmap="viridis", aspect="auto")
    ax.set_xticks(range(len(Ls)), Ls)
    ax.set_yticks(range(len(steps)), steps)
    ax.set_xlabel("trajectory length L")
    ax.set_ylabel("step size")
    ax.set_title(f"HMC ESS/gradient ({d}D standard normal)")
    fig.colorbar(im, label="min bulk ESS / gradient")
    path = os.path.join(out_dir, "hmc_step_length_map.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    print(f"  saved {path}")
    return grid


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dim", type=int, default=10)
    parser.add_argument("--out", type=str, default="examples_out")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if jax.default_backend() == "cpu":
        jax.config.update("jax_enable_x64", True)
    os.makedirs(args.out, exist_ok=True)

    from mcmc_tpu.targets import standard_normal
    target = standard_normal(args.dim)
    key = random.PRNGKey(args.seed)
    k1, k2 = random.split(key)

    print("RWMH proposal-scale sweep:")
    rwmh_scale_sweep(target, k1, out_dir=args.out)
    print("\nHMC (step, L) efficiency map:")
    hmc_step_length_map(target, k2, out_dir=args.out)


if __name__ == "__main__":
    main()
