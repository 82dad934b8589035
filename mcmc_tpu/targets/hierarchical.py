"""Hierarchical Bayesian logistic-regression posterior (BASELINE config 5).

Model (dim = p + 1 parameters):
    tau          ~ N(0, 1)                      (log of the coefficient scale)
    beta_i | tau ~ N(0, e^tau),  i = 1..p
    y_j | x_j    ~ Bernoulli(sigmoid(x_j . beta))

log p(beta, tau | X, y) = sum_j [ y_j z_j - log(1 + e^{z_j}) ]        z = X beta
                        - 0.5 e^{-tau} sum beta^2 - 0.5 p tau - 0.5 tau^2 + const

Hand-derived gradients:
    d/dbeta = X^T (y - sigmoid(z)) - beta e^{-tau}
    d/dtau  = 0.5 e^{-tau} sum beta^2 - p/2 - tau

The funnel-shaped hierarchy (tau controls every beta's scale) makes this the
production-realistic stress test; the likelihood term is a (chains, p) @
(p, n_data) matmul — tensor-core work, unlike the elementwise benchmark
targets.
Synthetic data is generated deterministically from the factory seed.
"""

import numpy as np

import jax
import jax.numpy as jnp
import jax.random as random

from mcmc_tpu.targets import TargetDistribution, _tag


def hierarchical_logistic(dim: int = 100, n_data: int = 256,
                          data_seed: int = 0) -> TargetDistribution:
    """dim = p + 1: p logistic coefficients + 1 log-scale hyperparameter."""
    p = dim - 1

    # Deterministic synthetic dataset: X ~ N(0,1), true beta at unit scale.
    rng = np.random.default_rng(data_seed)
    X_np = rng.normal(size=(n_data, p)).astype(np.float32)
    beta_true = rng.normal(size=p).astype(np.float32) * 0.5
    logits = X_np @ beta_true
    y_np = (rng.uniform(size=n_data) < 1.0 / (1.0 + np.exp(-logits)))
    X = jnp.asarray(X_np)
    y = jnp.asarray(y_np, jnp.float32)

    def value_and_grad_fn(q):
        """q: (..., dim) with q[..., 0] = tau, q[..., 1:] = beta."""
        q_dtype = q.dtype
        Xq = X.astype(q_dtype)
        yq = y.astype(q_dtype)
        tau = q[..., 0]
        beta = q[..., 1:]
        z = beta @ Xq.T                                  # (..., n_data) matmul
        # log-likelihood: sum y z - log1p(exp(z)), stable via logaddexp
        log_lik = jnp.sum(yq * z - jnp.logaddexp(0.0, z), axis=-1)
        inv_scale = jnp.exp(-tau)
        sum_b2 = jnp.sum(beta * beta, axis=-1)
        log_prior = (-0.5 * inv_scale * sum_b2 - 0.5 * p * tau
                     - 0.5 * tau * tau)
        lp = log_lik + log_prior

        resid = yq - jax.nn.sigmoid(z)                   # (..., n_data)
        g_beta = resid @ Xq - beta * inv_scale[..., None]
        g_tau = 0.5 * inv_scale * sum_b2 - 0.5 * p - tau
        grad = jnp.concatenate([g_tau[..., None], g_beta], axis=-1)
        return lp, grad

    def log_prob_fn(q):
        return value_and_grad_fn(q)[0]

    def init_sampler(key, n_chains):
        k1, k2 = random.split(key)
        tau = random.normal(k1, (n_chains, 1)) * 0.5
        beta = random.normal(k2, (n_chains, p)) * 0.3
        return jnp.concatenate([tau, beta], axis=1)

    _tag(value_and_grad_fn, "hierarchical_logistic", dim,
         n_data=n_data, data_seed=data_seed, X=X_np, y=y_np.astype(np.float32))

    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=None,      # posterior moments not tractable
        true_cov=None,
        name=f"HierarchicalLogistic{dim}D_n{n_data}",
        description=(f"{dim}D hierarchical Bayesian logistic posterior "
                     f"({p} coefficients + log-scale, {n_data} observations) "
                     f"- production-realistic funnel geometry with a matmul likelihood"),
        init_sampler=init_sampler,
        value_and_grad_fn=value_and_grad_fn,
        family="hierarchical_logistic",
        params={"n_data": n_data, "data_seed": data_seed},
    )
