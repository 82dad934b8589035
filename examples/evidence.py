#!/usr/bin/env python
"""Annealed-SMC walkthrough: evidence estimation and Bayesian model choice.

Demonstrates the second capability the reference lacks outright (nothing
in the reference estimates normalizing constants; SURVEY.md §2): annealed
Sequential Monte Carlo (samplers/smc.py) transports a particle population
from a Gaussian base to the target and returns an unbiased estimate of
Z = integral exp(logp) as a by-product of the transport.

Three acts:
  1. Calibration — an unnormalized Gaussian with ANALYTIC evidence:
     the estimate must hit (2 pi s^2)^{D/2} to Monte-Carlo error.
  2. Model comparison — conjugate Gaussian model (known noise, Gaussian
     prior on the mean) where the marginal likelihood is closed-form:
     SMC recovers the exact log-evidence of the true model and the
     Bayes factor against a mis-specified prior.
  3. Multimodal transport — the bimodal mixture from ONE generic wide
     base: both modes found with even mass, no split-mode init, and the
     normalized target's evidence reads 0.

Usage: python examples/evidence.py [--particles 2048] [--out examples_out]
"""

import argparse
import os

import numpy as np

import jax
from jax import random


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--particles", type=int, default=2048)
    parser.add_argument("--dim", type=int, default=4)
    parser.add_argument("--out", type=str, default="examples_out")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if jax.default_backend() == "cpu":
        jax.config.update("jax_enable_x64", True)
    os.makedirs(args.out, exist_ok=True)

    import jax.numpy as jnp

    from mcmc_tpu.samplers import smc_run, weighted_moments
    from mcmc_tpu.targets import gaussian_mixture

    key = random.PRNGKey(args.seed)
    k1, k2a, k2b, k3, k_data = random.split(key, 5)
    D, P = args.dim, args.particles

    # ---- Act 1: analytic calibration ----------------------------------
    s = 2.0
    true_logz = 0.5 * D * np.log(2 * np.pi * s ** 2)
    lp = lambda x: -0.5 * jnp.sum(x * x, axis=-1) / s ** 2
    vag = lambda x: (lp(x), -x / s ** 2)
    print(f"[1/3] Unnormalized Gaussian, D={D}, scale={s}: "
          f"true log Z = {true_logz:.4f}")
    r1 = smc_run(k1, lp, n_particles=P, dim=D, step_size=0.4, num_steps=8,
                 value_and_grad_fn=vag)
    print(f"      SMC log Z = {float(r1.log_Z):+.4f} "
          f"(error {float(r1.log_Z) - true_logz:+.4f}, "
          f"{int(r1.info['n_stages'])} bridge stages)")

    # ---- Act 2: Bayesian model comparison ------------------------------
    # y_i ~ N(theta, sigma^2 I), theta ~ N(0, tau^2 I). The marginal
    # likelihood p(y) is closed-form; SMC targets the UNNORMALIZED
    # posterior prior(theta) * likelihood(y | theta) whose normalizing
    # constant IS p(y).
    sigma, n_obs = 1.0, 12
    theta_true = jnp.full((D,), 1.2)
    y = theta_true + sigma * random.normal(k_data, (n_obs, D))
    ybar = jnp.mean(y, axis=0)
    ss_resid = float(jnp.sum((y - ybar) ** 2))

    def log_marginal(tau):
        """Exact log p(y): sufficiency factorizes each dimension into a
        tau-independent residual Gaussian times N(ybar_d; 0, sigma^2/n +
        tau^2)."""
        var_marg = sigma ** 2 / n_obs + tau ** 2
        resid = -0.5 * (n_obs - 1) * D * np.log(2 * np.pi * sigma ** 2) \
            - 0.5 * ss_resid / sigma ** 2 - 0.5 * D * np.log(n_obs)
        mean_fac = -0.5 * D * np.log(2 * np.pi * var_marg) \
            - 0.5 * float(jnp.sum(ybar ** 2)) / var_marg
        return resid + mean_fac

    def posterior(tau):
        def lp_post(th):
            pr = -0.5 * jnp.sum(th * th, axis=-1) / tau ** 2 \
                - 0.5 * D * jnp.log(2 * jnp.pi * tau ** 2)
            lik = -0.5 * (jnp.sum((y[None] - th[:, None, :]) ** 2,
                                  axis=(1, 2))) / sigma ** 2 \
                - 0.5 * n_obs * D * jnp.log(2 * jnp.pi * sigma ** 2)
            return pr + lik

        def vag_post(th):
            g = -(th / tau ** 2) - (n_obs * th - n_obs * ybar) / sigma ** 2
            return lp_post(th), g

        return lp_post, vag_post

    print(f"[2/3] Conjugate model comparison ({n_obs} obs, D={D}):")
    results = {}
    for name, tau, k in (("well-specified tau=2", 2.0, k2a),
                         ("tight mis-specified tau=0.2", 0.2, k2b)):
        lp_post, vag_post = posterior(tau)
        exact = log_marginal(tau)
        r = smc_run(k, lp_post, n_particles=P, dim=D, step_size=0.2,
                    num_steps=8, base_scale=2.0,
                    value_and_grad_fn=vag_post)
        results[name] = (float(r.log_Z), exact)
        print(f"      {name:28s} log p(y): SMC {float(r.log_Z):+.3f} "
              f"vs exact {exact:+.3f}")
    bf_smc = results["well-specified tau=2"][0] \
        - results["tight mis-specified tau=0.2"][0]
    bf_true = results["well-specified tau=2"][1] \
        - results["tight mis-specified tau=0.2"][1]
    print(f"      log Bayes factor (well vs tight): SMC {bf_smc:+.2f} "
          f"vs exact {bf_true:+.2f}")

    # ---- Act 3: multimodal transport ------------------------------------
    mix_dim = 10
    mt = gaussian_mixture(mix_dim, separation=5.0)
    print(f"[3/3] Bimodal mixture (sep=5, D={mix_dim}) from one wide base:")
    r3 = smc_run(k3, mt.log_prob_fn, n_particles=2 * P, dim=mix_dim,
                 step_size=0.4, num_steps=16, base_scale=6.0,
                 value_and_grad_fn=mt.value_and_grad_fn,
                 final_resample=True)
    x0 = np.asarray(r3.particles[:, 0])
    mean, cov = weighted_moments(r3.particles, r3.log_weights)
    print(f"      log Z = {float(r3.log_Z):+.4f} (normalized target: "
          f"true 0), right-mode fraction = {(x0 > 0).mean():.3f} "
          f"(true 0.5), Var[x0] = {x0.var():.2f} (true 7.25)")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        n = int(r3.info["n_stages"])
        fig, ax = plt.subplots(1, 2, figsize=(9, 3))
        ax[0].plot(np.asarray(r3.info["betas"][:n]), marker="o")
        ax[0].set_xlabel("stage")
        ax[0].set_ylabel("beta")
        ax[0].set_title("adaptive temperature ladder")
        ax[1].hist(x0, bins=60, density=True, color="tab:blue")
        ax[1].set_xlabel("x0")
        ax[1].set_title("transported particles")
        fig.tight_layout()
        path = os.path.join(args.out, "evidence_smc.png")
        fig.savefig(path, dpi=100)
        print(f"      wrote {path}")
    except Exception as e:                      # matplotlib optional
        print(f"      plot skipped: {e}")


if __name__ == "__main__":
    main()
