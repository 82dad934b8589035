"""Target distribution tests: analytic grads vs jax.grad, moments, samplers."""

import jax
import jax.numpy as jnp
import jax.random as random
import numpy as np
import pytest

from mcmc_tpu.targets import (
    get_target, get_reference_sampler, has_reference_sampler,
    standard_normal, correlated_gaussian, ill_conditioned_gaussian,
    neals_funnel, log_gamma, student_t, rosenbrock, gaussian_mixture,
)

ALL_NAMES = [
    "standard_normal", "correlated_gaussian", "ill_conditioned_gaussian",
    "student_t", "log_gamma", "rosenbrock", "neals_funnel",
    "neals_funnel_noncentered", "gaussian_mixture",
    "multimodal_funnel_2d", "concentric_l1_2d", "concentric_l1_3d",
    "nested_l1_2d", "nested_l1_3d", "hierarchical_logistic",
    # the unconstraining-reparameterization layer (beyond-reference):
    # log-transformed log_gamma, registered under the generic
    # '<name>_unconstrained' suffix
    "log_gamma_unconstrained",
]


def _positions_for(target, key, n=16):
    """Draw test positions from the target's support."""
    if target.init_sampler is not None:
        return target.init_sampler(key, n)
    return random.normal(key, (n, target.dim))


@pytest.mark.parametrize("name", ALL_NAMES)
def test_analytic_grad_matches_autodiff(name):
    target = get_target(name, dim=7 if name not in (
        "multimodal_funnel_2d", "concentric_l1_2d", "nested_l1_2d") else 2)
    key = random.PRNGKey(0)
    x = _positions_for(target, key).astype(jnp.float64)

    lp_analytic, grad_analytic = target.value_and_grad_fn(x)
    lp_auto, grad_auto = jax.vmap(jax.value_and_grad(target.log_prob_fn))(x)

    np.testing.assert_allclose(np.asarray(lp_analytic), np.asarray(lp_auto),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.asarray(grad_analytic), np.asarray(grad_auto),
                               rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("name", ALL_NAMES)
def test_log_prob_batched_matches_single(name):
    target = get_target(name)
    key = random.PRNGKey(1)
    x = _positions_for(target, key, n=5)
    batched = target.log_prob_fn(x)
    singles = jnp.stack([target.log_prob_fn(x[i]) for i in range(5)])
    np.testing.assert_allclose(np.asarray(batched), np.asarray(singles), rtol=1e-12)


@pytest.mark.parametrize("name", [n for n in ALL_NAMES if has_reference_sampler(n)
                                  and n != "rosenbrock"])
def test_reference_sampler_moments(name):
    """Exact samplers must reproduce the analytic moments."""
    target = get_target(name)
    sampler = get_reference_sampler(name, dim=target.dim)
    samples = sampler(random.PRNGKey(2), 200_000)
    assert samples.shape == (200_000, target.dim)

    mean = jnp.mean(samples, axis=0)
    # Monte Carlo error of the mean: sd/sqrt(n); 5-sigma tolerance.
    sd = jnp.std(samples, axis=0)
    tol = 5.0 * sd / jnp.sqrt(200_000.0)
    assert jnp.all(jnp.abs(mean - target.true_mean) < tol + 1e-6), (
        f"{name}: mean {mean} vs {target.true_mean}")

    if target.true_cov is not None and name != "student_t":
        # Variance check (looser: 4th-moment-driven error). Skip student_t
        # (df=3 has infinite 4th moment, variance estimate converges slowly).
        var = jnp.var(samples, axis=0)
        true_var = jnp.diag(target.true_cov)
        if name in ("neals_funnel", "multimodal_funnel_2d"):
            # Funnel tails are log-normal: kurtosis ~ 3 e^9, so the variance
            # estimator of the non-neck dims barely converges at n=200k.
            # Check only the neck dimension (Gaussian, var 9 / mu^2+sigma^2).
            var, true_var = var[:1], true_var[:1]
        rel_err = jnp.abs(var - true_var) / true_var
        assert jnp.all(rel_err < 0.15), f"{name}: var {var} vs {true_var}"


def test_log_gamma_support_guard():
    target = get_target("log_gamma", dim=4)
    x_bad = jnp.array([[1.0, -0.5, 2.0, 1.0]])
    lp, grad = target.value_and_grad_fn(x_bad)
    assert jnp.isneginf(lp[0])
    assert jnp.all(jnp.isfinite(grad))


def test_funnel_true_variance_constant():
    """Var of funnel non-neck dims is exp(4.5) (reference targets.py:199)."""
    t = neals_funnel(10)
    assert np.isclose(float(t.true_cov[1, 1]), np.exp(4.5))


def test_mixture_true_variance():
    t = gaussian_mixture(10, separation=5.0)
    assert np.isclose(float(t.true_cov[0, 0]), 1.0 + 2.5**2)


def test_get_target_unknown_raises():
    with pytest.raises(ValueError):
        get_target("nope")


def test_registry_names_match_reference():
    for name in ALL_NAMES:
        t = get_target(name)
        assert t.dim >= 2
        assert t.log_prob_fn is not None and t.value_and_grad_fn is not None


def test_value_and_grad_works_unbatched():
    t = standard_normal(5)
    x = jnp.arange(5.0)
    lp, g = t.value_and_grad_fn(x)
    assert lp.shape == () and g.shape == (5,)


def test_unconstrain_log_gamma_density_consistency():
    """lp_y(y) must equal lp_x(e^y) + sum(y) — the change-of-variables
    identity the whole reparam layer rests on (Stan reference manual
    ch. 10; reference targets.py:216-270 has no such layer, which is why
    its log_gamma rows only survive via the hard-coded 0.0 divergence
    rate at run_benchmarks.py:706-710)."""
    from mcmc_tpu.targets import unconstrain_target

    base = get_target("log_gamma", dim=7)
    unc = get_target("log_gamma_unconstrained", dim=7)
    assert unc.support == "real" and base.support == "positive"
    assert unc.transform_target == "log_gamma"

    y = random.normal(random.PRNGKey(4), (16, 7)).astype(jnp.float64)
    lp_y, g_y = unc.value_and_grad_fn(y)
    lp_expected = base.log_prob_fn(jnp.exp(y)) + jnp.sum(y, axis=-1)
    np.testing.assert_allclose(np.asarray(lp_y), np.asarray(lp_expected),
                               rtol=1e-10, atol=1e-10)
    # transform maps back to the positive orthant
    x = unc.transform(y)
    assert bool(jnp.all(x > 0))
    # constrained-coordinate ground truth rides along for the runner's
    # transformed z-test
    np.testing.assert_allclose(np.asarray(unc.transform_true_mean),
                               np.asarray(base.true_mean))


def test_unconstrain_generic_chain_rule_matches_specialized():
    """The generic positive-support wrapper (grad_y = grad_x(e^y)*e^y + 1)
    must agree with log_gamma's specialized analytic expGamma form away
    from the clamp region."""
    from mcmc_tpu.targets import unconstrain_target, log_gamma

    base = get_target("log_gamma", dim=7)
    specialized = unconstrain_target(base, registry_name="log_gamma")
    # re-tag the family so unconstrain_target takes the generic path
    generic = unconstrain_target(base._replace(family="fake_positive"),
                                 registry_name="log_gamma")
    assert generic.true_mean is None        # no analytic moments generically

    y = (random.normal(random.PRNGKey(5), (16, 7)) * 2.0).astype(jnp.float64)
    lp_s, g_s = specialized.value_and_grad_fn(y)
    lp_g, g_g = generic.value_and_grad_fn(y)
    np.testing.assert_allclose(np.asarray(lp_s), np.asarray(lp_g),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(g_s), np.asarray(g_g),
                               rtol=1e-9, atol=1e-9)


def test_unconstrain_real_support_is_identity():
    from mcmc_tpu.targets import unconstrain_target

    t = get_target("standard_normal", dim=7)
    assert unconstrain_target(t) is t


def test_unconstrained_padded_builder_matches_xla():
    """The Pallas family 'log_gamma_unconstrained' (ops/padded_targets.py)
    must agree with the target's own value-and-grad at two block widths,
    with padded entries contributing nothing."""
    from mcmc_tpu.ops.padded_targets import make_padded_vag

    unc = get_target("log_gamma_unconstrained", dim=7)
    y = random.normal(random.PRNGKey(6), (8, 7)).astype(jnp.float32)
    lp_ref, g_ref = unc.value_and_grad_fn(y)

    for d_pad in (16, 128):
        pv = make_padded_vag(unc.value_and_grad_fn, d_pad)
        q = jnp.zeros((8, d_pad), jnp.float32).at[:, :7].set(y)
        lp, g = pv(q)
        assert np.all(np.asarray(g[:, 7:]) == 0.0)
        g = g[:, :7]
        np.testing.assert_allclose(np.asarray(lp).reshape(-1),
                                   np.asarray(lp_ref), rtol=2e-5, atol=2e-4)
        np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                                   rtol=2e-5, atol=2e-5)


def test_unconstrained_hmc_has_zero_divergences_where_constrained_diverges():
    """The round-5 headline fix: HMC on constrained log_gamma diverges at
    the support boundary (real |dH| > 1000 detection), while the same
    budget on the log-transformed target is divergence-free and recovers
    the GAMMA moments after mapping back."""
    from mcmc_tpu.samplers import hmc_run

    base = get_target("log_gamma", dim=5)
    unc = get_target("log_gamma_unconstrained", dim=5)
    key = random.PRNGKey(7)
    init_u = unc.init_sampler(key, 8)

    res = hmc_run(random.PRNGKey(8), unc.log_prob_fn, init_u,
                  step_size=0.25, num_steps=10, num_samples=1500,
                  burn_in=300, value_and_grad_fn=unc.value_and_grad_fn)
    assert int(res.info["total_divergences"]) == 0
    x = np.asarray(unc.transform(res.samples)).reshape(-1, 5)
    mean = x.mean(axis=0)
    np.testing.assert_allclose(mean, np.asarray(base.true_mean),
                               rtol=0.12)


def test_noncentered_funnel_transform_recovers_funnel_moments():
    """funnel_transform maps exact non-centered draws to draws with the
    centered funnel's moments (Var[x0]=9, Var[x_i]=e^{4.5}; reference
    targets.py:199-203) — the green-gate funnel remedy (VERDICT r2 #5)."""
    from mcmc_tpu.targets import funnel_transform, neals_funnel_noncentered

    t = neals_funnel_noncentered(6)
    assert t.transform is funnel_transform
    sampler = get_reference_sampler("neals_funnel_noncentered", dim=6)
    y = sampler(random.PRNGKey(3), 400_000)
    x = funnel_transform(y)

    # x0 is v itself
    np.testing.assert_allclose(np.asarray(x[:, 0]), np.asarray(y[:, 0]))
    var = np.var(np.asarray(x), axis=0)
    assert abs(var[0] - 9.0) / 9.0 < 0.05
    v_rest = float(np.exp(4.5))
    # heavy-tailed (log-normal-scaled) coordinates: generous MC tolerance
    assert np.all(np.abs(var[1:] - v_rest) / v_rest < 0.5)

    # funnel log-density of transformed draws equals non-centered density
    # minus the log-Jacobian (d-1)/2 * v of the transform
    f = get_target("neals_funnel", dim=6)
    lp_f = np.asarray(f.log_prob_fn(x[:100]))
    lp_nc = np.asarray(t.log_prob_fn(y[:100]))
    jac = 2.5 * np.asarray(y[:100, 0])      # (dim-1)/2 * v
    np.testing.assert_allclose(lp_f, lp_nc - jac, rtol=1e-8, atol=1e-8)
