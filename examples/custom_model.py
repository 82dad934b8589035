#!/usr/bin/env python
"""Bring-your-own-model walkthrough: Bayesian logistic regression.

The benchmark targets are built in, but the framework's real job is USER
models: write a batched log-posterior, hand it to the tuner and a sampler,
read the posterior. This example fits Bayesian logistic regression on
synthetic data end to end:

  1. a custom batched log-posterior (JAX autodiff supplies the gradients —
     no analytic derivation needed, though `value_and_grad_fn` accepts one),
  2. `run_adaptive_warmup` (Stan-style windowed adaptation: dual-averaged
     step size + Welford diagonal metric),
  3. `nuts_run_persistent` (the asynchronous batched NUTS),
  4. diagnostics, credible intervals, truth recovery and held-out accuracy.

The same log_prob_fn composes unchanged with every other surface: wrap it
in a `TargetDistribution` for the benchmark CLI, pass `mesh=` for
multi-chip (examples/multichip_sampling.py), or feed it to `smc_run` for
model evidence (examples/evidence.py).

Reference parity note: the reference (run_benchmarks.py, targets.py:23-31)
only exercises its built-in benchmark targets; this user-model path is the
framework story the reference leaves implicit.

Usage: python examples/custom_model.py [--n-data 400] [--n-features 8]
       [--chains 64] [--num-warmup 600] [--num-samples 500]
"""

import argparse
import os

import numpy as np

import jax
import jax.numpy as jnp
from jax import random


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--n-data", type=int, default=400)
    parser.add_argument("--n-features", type=int, default=8)
    parser.add_argument("--chains", type=int, default=64)
    parser.add_argument("--num-warmup", type=int, default=600)
    parser.add_argument("--num-samples", type=int, default=500)
    parser.add_argument("--steps-per-sample", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if jax.default_backend() == "cpu":
        jax.config.update("jax_enable_x64", True)

    from mcmc_tpu.samplers import nuts_run_persistent
    from mcmc_tpu.tuning import run_adaptive_warmup
    from mcmc_tpu.diagnostics import compute_diagnostics

    # ------------------------------------------------------------------
    # 1. Synthetic data: y ~ Bernoulli(sigmoid(X @ beta_true))
    # ------------------------------------------------------------------
    key = random.PRNGKey(args.seed)
    k_x, k_beta, k_y, k_init, k_warm, k_sample = random.split(key, 6)
    n, p = args.n_data, args.n_features
    X = random.normal(k_x, (n, p))
    beta_true = random.normal(k_beta, (p,)) * 1.5
    logits = X @ beta_true
    y = (random.uniform(k_y, (n,)) < jax.nn.sigmoid(logits)).astype(
        jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    # held-out split for a posterior-predictive check
    n_train = int(0.8 * n)
    X_tr, y_tr, X_te, y_te = X[:n_train], y[:n_train], X[n_train:], y[n_train:]
    print(f"[1/4] data: {n_train} train / {n - n_train} test rows, "
          f"{p} features")

    # ------------------------------------------------------------------
    # 2. The model: a BATCHED log-posterior. beta has shape (..., p) —
    #    every sampler vectorizes over leading chain axes, so the only
    #    contract is "batched in, batched out". Gradients come from JAX
    #    autodiff; pass value_and_grad_fn instead if you have analytic
    #    ones (the built-in targets do, for the fused Pallas kernels).
    # ------------------------------------------------------------------
    prior_scale = 5.0

    def log_posterior(beta):
        z = beta @ X_tr.T                                    # (..., n_train)
        log_lik = jnp.sum(y_tr * z - jnp.logaddexp(0.0, z), axis=-1)
        log_prior = -0.5 * jnp.sum(beta**2, axis=-1) / prior_scale**2
        return log_lik + log_prior

    # ------------------------------------------------------------------
    # 3. Tune, then sample.
    # ------------------------------------------------------------------
    init = random.normal(k_init, (args.chains, p)) * 0.1
    print(f"[2/4] windowed warmup ({args.num_warmup} steps, "
          f"{args.chains} chains) ...")
    step_size, inv_mass, position, winfo = run_adaptive_warmup(
        "nuts", log_posterior, None, init, k_warm,
        num_warmup=args.num_warmup, verbose=False)
    print(f"  tuned: step_size={step_size:.4f}, "
          f"metric range [{float(jnp.min(inv_mass)):.3f}, "
          f"{float(jnp.max(inv_mass)):.3f}]")

    print(f"[3/4] persistent NUTS ({args.num_samples} snapshots x "
          f"{args.chains} chains) ...")
    res = nuts_run_persistent(
        k_sample, log_posterior, position, step_size,
        num_samples=args.num_samples,
        steps_per_sample=args.steps_per_sample,
        inv_mass_matrix=inv_mass)
    samples = res.samples                   # (num_samples, chains, p)

    # ------------------------------------------------------------------
    # 4. Read the posterior.
    # ------------------------------------------------------------------
    diag = compute_diagnostics(samples)
    print(f"[4/4] R-hat max={diag['rhat_max']:.4f}  "
          f"bulk-ESS min={diag['ess_bulk_min']:.0f}  "
          f"accept={float(res.accept_rate.mean()):.3f}")

    flat = np.asarray(samples).reshape(-1, p)
    post_mean = flat.mean(axis=0)
    lo, hi = np.percentile(flat, [2.5, 97.5], axis=0)
    covered = int(np.sum((lo <= np.asarray(beta_true))
                         & (np.asarray(beta_true) <= hi)))
    print("\n  coef   truth   post.mean   95% interval")
    for j in range(p):
        print(f"  b{j:<4d} {float(beta_true[j]):7.3f}   {post_mean[j]:7.3f}"
              f"   [{lo[j]:7.3f}, {hi[j]:7.3f}]")
    print(f"  truth inside the 95% interval: {covered}/{p}")

    # posterior-predictive accuracy on held-out rows, against the accuracy
    # the TRUE coefficients achieve (the ceiling for this data)
    p_te = np.asarray(jax.nn.sigmoid(flat @ np.asarray(X_te).T)).mean(axis=0)
    acc = float(np.mean((p_te > 0.5) == np.asarray(y_te)))
    acc_true = float(np.mean(
        (np.asarray(jax.nn.sigmoid(X_te @ beta_true)) > 0.5)
        == np.asarray(y_te)))
    print(f"  held-out accuracy: posterior {acc:.3f} vs truth-ceiling "
          f"{acc_true:.3f}")

    # ------------------------------------------------------------------
    # 5. Predictive scoring: PSIS-LOO cross-validation from the SAME
    #    draws (no refits). The pointwise log-likelihood matrix is the
    #    only input; khat localizes any datapoint whose leave-one-out
    #    posterior the draws can't represent (> 0.7 = don't trust that
    #    point). Fit a competing model the same way and rank with
    #    `mcmc_tpu.diagnostics.compare({...})` — paired d_elpd +/- d_se.
    # ------------------------------------------------------------------
    from mcmc_tpu.diagnostics import psis_loo, pointwise_log_likelihood

    def pointwise_ll(beta):
        z = X_tr @ beta                                     # (n_train,)
        return y_tr * z - jnp.logaddexp(0.0, z)

    ll = pointwise_log_likelihood(pointwise_ll, samples)
    loo = psis_loo(ll)
    khat_max = float(np.max(np.asarray(loo.khat)))
    print(f"\n  PSIS-LOO: elpd={loo.elpd:.1f} +/- {loo.se:.1f}  "
          f"p_eff={loo.p_eff:.1f}  max khat={khat_max:.2f} "
          f"({loo.n_bad_khat} points > 0.7)")
    if loo.n_bad_khat:
        print("  WARNING: some leave-one-out posteriors are unreliable "
              "(khat > 0.7) — refit without those points to check them")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
