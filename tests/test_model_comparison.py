"""WAIC / PSIS-LOO / compare: validated against closed forms.

The strongest check is the conjugate normal-normal model, where the exact
leave-one-out predictive density is analytic — PSIS-LOO's per-datapoint
elpd_i must reproduce it from posterior draws alone. The GPD fitter is
validated on synthetic generalized-Pareto tails with known shape.
"""

import numpy as np
import pytest
import jax.numpy as jnp
from jax import random

from mcmc_tpu.diagnostics import (
    psis_loo, waic, compare, pointwise_log_likelihood,
)
from mcmc_tpu.diagnostics.model_comparison import _gpd_fit, _gpd_quantile


def _conjugate_setup(seed=0, n=40, tau=2.0, s=1.0, mu_true=0.7, S=4000):
    """y_i ~ N(mu, s^2), mu ~ N(0, tau^2): posterior and exact LOO are
    closed-form. Returns (y, posterior draws, ll matrix, exact elpd_i)."""
    rng = np.random.default_rng(seed)
    y = rng.normal(mu_true, s, size=n)

    def posterior(y_sub):
        prec = 1.0 / tau**2 + len(y_sub) / s**2
        mean = (y_sub.sum() / s**2) / prec
        return mean, 1.0 / prec

    mu_n, var_n = posterior(y)
    draws = rng.normal(mu_n, np.sqrt(var_n), size=S)
    ll = -0.5 * ((y[None, :] - draws[:, None]) / s) ** 2 \
        - 0.5 * np.log(2 * np.pi * s**2)

    # exact LOO: p(y_i | y_{-i}) = N(y_i; mu_{-i}, var_{-i} + s^2)
    exact = np.empty(n)
    for i in range(n):
        m, v = posterior(np.delete(y, i))
        exact[i] = -0.5 * (y[i] - m) ** 2 / (v + s**2) \
            - 0.5 * np.log(2 * np.pi * (v + s**2))
    return y, draws, jnp.asarray(ll), exact


def test_psis_loo_matches_exact_conjugate_loo():
    _, _, ll, exact = _conjugate_setup()
    r = psis_loo(ll)
    elpd_i = np.asarray(r.elpd_i)
    # per-point agreement: MC error at S=4000 on a well-specified model
    assert np.max(np.abs(elpd_i - exact)) < 0.05
    assert abs(r.elpd - exact.sum()) < 0.3
    # well-specified conjugate model: every tail is light
    assert r.n_bad_khat == 0
    assert float(np.max(np.asarray(r.khat))) < 0.7
    # p_eff ~ 1 effective parameter (a single mean)
    assert 0.3 < r.p_eff < 2.0
    assert r.se > 0


def test_waic_agrees_with_loo_when_well_specified():
    _, _, ll, exact = _conjugate_setup(seed=3)
    w = waic(ll)
    r = psis_loo(ll)
    assert abs(w.elpd - r.elpd) < 0.2          # Vehtari et al. 2017 sec 2.2
    assert abs(w.elpd - exact.sum()) < 0.3
    assert w.n_high_penalty == 0
    assert 0.3 < w.p_eff < 2.0


def test_gpd_fit_recovers_known_shapes():
    """Synthetic GPD(sigma=1, k) tails: the Zhang-Stephens fit must
    recover k within its sampling error, heavy AND bounded tails."""
    key = random.PRNGKey(0)
    for k_true in (-0.2, 0.3, 0.7):
        key, sub = random.split(key)
        u = random.uniform(sub, (2000,), dtype=jnp.float64,
                           minval=1e-6, maxval=1 - 1e-6)
        x = _gpd_quantile(u, jnp.float64(k_true), jnp.float64(1.0))
        k_hat, sigma_hat = _gpd_fit(x)
        assert abs(float(k_hat) - k_true) < 0.1, (k_true, float(k_hat))
        assert 0.8 < float(sigma_hat) < 1.25, (k_true, float(sigma_hat))


def test_outlier_datapoint_has_highest_khat():
    """An extreme datapoint makes ITS leave-one-out importance ratios the
    heaviest-tailed column — khat must localize the problem."""
    rng = np.random.default_rng(1)
    y = rng.normal(0.0, 1.0, size=30)
    y[7] = 8.0                                  # catastrophic outlier
    draws = rng.normal(y.mean(), 1.0 / np.sqrt(len(y)), size=3000)
    ll = jnp.asarray(-0.5 * (y[None, :] - draws[:, None]) ** 2
                     - 0.5 * np.log(2 * np.pi))
    r = psis_loo(ll)
    khat = np.asarray(r.khat)
    assert int(np.argmax(khat)) == 7
    assert khat[7] > np.median(khat) + 0.2


def test_compare_ranks_true_model_first():
    """True model (s=1) vs misspecified wide model (s=3) on the same data:
    compare() must rank the true model first with a paired d_se."""
    rng = np.random.default_rng(2)
    n, S = 50, 3000
    y = rng.normal(0.0, 1.0, size=n)
    draws = rng.normal(y.mean(), 1.0 / np.sqrt(n), size=S)

    def ll_mat(s):
        return jnp.asarray(
            -0.5 * ((y[None, :] - draws[:, None]) / s) ** 2
            - 0.5 * np.log(2 * np.pi * s**2))

    good = psis_loo(ll_mat(1.0))
    bad = psis_loo(ll_mat(3.0))
    out = compare({"wide": bad, "true": good})
    assert out["ranking"][0] == "true"
    t = out["table"]
    assert t["true"]["d_elpd"] == 0.0
    assert t["wide"]["d_elpd"] < 0.0
    assert t["wide"]["d_se"] > 0.0
    # the misspecification is many sigma: the difference must be decisive
    assert -t["wide"]["d_elpd"] > 4 * t["wide"]["d_se"]


def test_compare_rejects_mismatched_data_sizes():
    _, _, ll, _ = _conjugate_setup(n=40)
    _, _, ll2, _ = _conjugate_setup(n=30)
    with pytest.raises(ValueError, match="different data sizes"):
        compare({"a": psis_loo(ll), "b": psis_loo(ll2)})


def test_pointwise_log_likelihood_builder_and_history_shapes():
    """(draws, chains, dim) histories flatten; the builder vmaps a
    per-draw fn; both entry points give identical results."""
    rng = np.random.default_rng(4)
    y = jnp.asarray(rng.normal(size=12))
    hist = jnp.asarray(rng.normal(size=(50, 4, 1)))   # 200 draws of mu

    def ll_fn(theta):
        return -0.5 * (y - theta[0]) ** 2 - 0.5 * jnp.log(2 * jnp.pi)

    ll = pointwise_log_likelihood(ll_fn, hist)
    assert ll.shape == (200, 12)
    r3 = psis_loo(jnp.reshape(ll, (50, 4, 12)))       # 3-D entry point
    r2 = psis_loo(ll)
    assert np.allclose(float(r3.elpd), float(r2.elpd))
    w = waic(ll)
    assert np.isfinite(w.elpd)


def test_psis_loo_rejects_tiny_sample():
    with pytest.raises(ValueError, match=">= 25 draws"):
        psis_loo(jnp.zeros((10, 5)))


def test_constant_likelihood_column_never_nans():
    """A theta-independent datapoint (constant ll column) has zero-spread
    importance ratios: PSIS must keep the raw (uniform) weights and report
    khat = -inf for it, never NaN, and its elpd_i must equal its ll."""
    rng = np.random.default_rng(5)
    draws = rng.normal(size=500)
    y = rng.normal(size=6)
    ll = -0.5 * (y[None, :] - draws[:, None]) ** 2
    ll[:, 3] = -1.234                            # constant column
    r = psis_loo(jnp.asarray(ll))
    elpd_i = np.asarray(r.elpd_i)
    khat = np.asarray(r.khat)
    assert np.all(np.isfinite(elpd_i))
    assert np.isclose(elpd_i[3], -1.234)
    assert khat[3] == -np.inf
    assert np.all(np.isfinite(khat[np.arange(6) != 3]))


def test_hdi_and_summary_table():
    """hdi() matches the analytic normal interval; summary() returns the
    az.summary-style per-dim table built from the gate estimators."""
    from mcmc_tpu.diagnostics import hdi, summary
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.normal(size=(500, 8, 3)) * np.array([1.0, 2.0, 0.5]))
    lo, hi = hdi(x, hdi_prob=0.95)
    # N(0, s): central 95% ~ +/- 1.96 s (HDI == central by symmetry)
    for j, s in enumerate([1.0, 2.0, 0.5]):
        assert abs(lo[j] + 1.96 * s) < 0.25 * s, (j, lo[j])
        assert abs(hi[j] - 1.96 * s) < 0.25 * s, (j, hi[j])
    df = summary(x, hdi_prob=0.95, var_names=["a", "b", "c"])
    assert df["variable"] == ["a", "b", "c"]
    assert {"mean", "sd", "mcse_mean", "ess_bulk", "ess_tail",
            "r_hat"} <= set(df)
    assert (df["r_hat"] < 1.02).all()
    assert np.allclose(df["hdi_lo_95%"], lo)
    with pytest.raises(ValueError, match="hdi_prob"):
        hdi(x, hdi_prob=1.5)


def test_gpd_shrinkage_prior_constant():
    """The k-hat shrinkage prior is (M k + 10*0.5)/(M + 10) (Vehtari et
    al. 2024 / arviz): at tiny M the regularized estimate must sit
    visibly between the raw fit and the 0.5 prior center (a 2.5
    numerator — a previously-shipped bug — would drag it toward 0.25)."""
    rng = np.random.default_rng(9)
    # heavy synthetic tail, k_true = 0.8, tiny sample M=20
    u = rng.uniform(1e-4, 1 - 1e-4, 20)
    x = _gpd_quantile(jnp.asarray(u), jnp.float64(0.8), jnp.float64(1.0))
    k_hat, _ = _gpd_fit(x)
    # raw fits scatter around 0.8; shrinkage pulls toward 0.5 by
    # 10/(M+10) = 1/3. With the wrong 2.5 numerator the pull target is
    # 0.25 and estimates land ~0.08 lower.
    M = 20
    k_lo = (M * 0.3 + 5.0) / (M + 10)    # generous raw-fit scatter bounds
    k_hi = (M * 1.4 + 5.0) / (M + 10)
    assert k_lo < float(k_hat) < k_hi


def test_summary_accepts_flat_draws():
    """summary() accepts (n, dim) pooled draws like hdi() does (treated
    as a single chain)."""
    from mcmc_tpu.diagnostics import summary
    rng = np.random.default_rng(10)
    flat = jnp.asarray(rng.normal(size=(400, 3)))
    df = summary(flat)
    assert len(df["variable"]) == 3 and df["r_hat"].shape == (3,)
    assert np.all(np.isfinite(df["r_hat"]))
