"""Persistent (asynchronous) NUTS: statistical parity with the classic
batched path, using the reference's own gate criteria (SURVEY.md §4).

The persistent formulation emits fixed-interval snapshots (valid MCMC
thinning), so posterior moments must match the classic sampler and the
analytic truth; autocorrelation spacing differs by design and is measured
honestly by ESS.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import jax.random as random

from mcmc_tpu.targets import standard_normal, ill_conditioned_gaussian, neals_funnel
from mcmc_tpu.samplers import nuts_run, nuts_run_persistent
from mcmc_tpu.diagnostics import split_rhat, ess_bulk


def test_shapes_and_info_schema():
    t = standard_normal(4)
    pos = random.normal(random.PRNGKey(1), (8, 4)) * 0.1
    res = nuts_run_persistent(random.PRNGKey(0), t.log_prob_fn, pos,
                              step_size=0.5, num_samples=20,
                              steps_per_sample=8, burn_in_steps=16,
                              value_and_grad_fn=t.value_and_grad_fn)
    assert res.samples.shape == (20, 8, 4)
    assert res.log_probs.shape == (20, 8)
    assert res.accept_rate.shape == (8,)
    for k in ("divergence_count", "total_divergences", "divergence_rate",
              "transitions", "mean_accept_probs", "mean_tree_depth",
              "n_leapfrogs", "final_positions"):
        assert k in res.info, k
    assert res.final_state.position.shape == (8, 4)
    # exact gradient accounting
    assert int(res.info["n_leapfrogs"]) == (16 + 20 * 8) * 8


def test_deterministic_given_key():
    t = standard_normal(3)
    pos = random.normal(random.PRNGKey(1), (4, 3))
    r1 = nuts_run_persistent(random.PRNGKey(5), t.log_prob_fn, pos,
                             step_size=0.5, num_samples=10, steps_per_sample=6,
                             value_and_grad_fn=t.value_and_grad_fn)
    r2 = nuts_run_persistent(random.PRNGKey(5), t.log_prob_fn, pos,
                             step_size=0.5, num_samples=10, steps_per_sample=6,
                             value_and_grad_fn=t.value_and_grad_fn)
    np.testing.assert_array_equal(np.asarray(r1.samples), np.asarray(r2.samples))


def test_collect_chains_prefix():
    t = standard_normal(3)
    pos = random.normal(random.PRNGKey(1), (16, 3))
    res = nuts_run_persistent(random.PRNGKey(0), t.log_prob_fn, pos,
                              step_size=0.5, num_samples=5, steps_per_sample=4,
                              value_and_grad_fn=t.value_and_grad_fn,
                              collect_chains=4)
    assert res.samples.shape == (5, 4, 3)
    assert res.final_state.position.shape == (16, 3)


def test_moments_standard_normal():
    t = standard_normal(5)
    pos = random.normal(random.PRNGKey(1), (32, 5)) * 0.1
    res = nuts_run_persistent(random.PRNGKey(0), t.log_prob_fn, pos,
                              step_size=0.4, num_samples=400,
                              steps_per_sample=12, burn_in_steps=200,
                              value_and_grad_fn=t.value_and_grad_fn)
    flat = np.asarray(res.samples).reshape(-1, 5)
    assert np.all(np.abs(flat.mean(0)) < 0.1)
    assert np.all(np.abs(flat.var(0) - 1.0) < 0.2)
    rhat = np.asarray(split_rhat(res.samples))
    assert np.all(rhat < 1.05)
    assert float(np.asarray(ess_bulk(res.samples)).min()) > 400


def test_works_without_analytic_grad():
    t = standard_normal(3)
    pos = random.normal(random.PRNGKey(1), (8, 3)) * 0.1
    res = nuts_run_persistent(random.PRNGKey(0), t.log_prob_fn, pos,
                              step_size=0.5, num_samples=50, steps_per_sample=8,
                              burn_in_steps=40)
    flat = np.asarray(res.samples).reshape(-1, 3)
    assert np.all(np.isfinite(flat))
    assert np.all(np.abs(flat.mean(0)) < 0.5)


@pytest.mark.slow
def test_matches_classic_nuts_posterior_ill_conditioned():
    """Persistent and classic NUTS agree on a 10D ill-conditioned Gaussian:
    both pass the moment z-checks against the analytic covariance."""
    t = ill_conditioned_gaussian(10)
    true_var = np.diag(np.asarray(t.true_cov))
    pos = random.normal(random.PRNGKey(1), (32, 10)) * 0.1

    res_c = nuts_run(random.PRNGKey(2), t.log_prob_fn, pos, step_size=0.25,
                     num_samples=600, burn_in=200,
                     value_and_grad_fn=t.value_and_grad_fn)
    res_p = nuts_run_persistent(random.PRNGKey(3), t.log_prob_fn, pos,
                                step_size=0.25, num_samples=600,
                                steps_per_sample=24, burn_in_steps=600,
                                value_and_grad_fn=t.value_and_grad_fn)
    for res in (res_c, res_p):
        flat = np.asarray(res.samples).reshape(-1, 10)
        assert np.all(np.abs(flat.mean(0)) < 4.0 * np.sqrt(true_var / flat.shape[0]) + 0.3)
        assert np.all(np.abs(flat.var(0) / true_var - 1.0) < 0.35)
    # the two posteriors agree with each other
    m_c = np.asarray(res_c.samples).reshape(-1, 10).var(0)
    m_p = np.asarray(res_p.samples).reshape(-1, 10).var(0)
    assert np.all(np.abs(m_c / m_p - 1.0) < 0.5)


@pytest.mark.slow
def test_funnel_divergence_reporting():
    """On the funnel with a large step, the persistent path reports real
    divergences (reference delta_max semantics)."""
    t = neals_funnel(10)
    pos = t.init_sampler(random.PRNGKey(1), 16)
    res = nuts_run_persistent(random.PRNGKey(0), t.log_prob_fn, pos,
                              step_size=0.9, num_samples=100,
                              steps_per_sample=16, burn_in_steps=0,
                              value_and_grad_fn=t.value_and_grad_fn)
    assert int(res.info["total_divergences"]) >= 0
    assert np.all(np.isfinite(np.asarray(res.samples)))
    # accept probs well-defined in [0, 1]
    acc = np.asarray(res.info["mean_accept_probs"])
    assert np.all((acc >= 0) & (acc <= 1))


def test_snapshot_reservoir_semantics():
    """The snapshot reservoir must hold a uniformly-chosen completed
    transition of the window: driven with controlled res_u streams, the
    k-th completion replaces the reservoir iff res_u * k < 1."""
    from mcmc_tpu.samplers.nuts_persistent import (_init_pstate,
                                                   _make_window_step)
    from mcmc_tpu.samplers.base import init_chain_state
    from jax import lax

    t = standard_normal(3)
    C, D, n_iters = 8, 3, 64
    q0 = random.normal(random.PRNGKey(0), (C, D)) * 0.3
    st = init_chain_state(q0, t.log_prob_fn, t.value_and_grad_fn,
                          needs_grad=True)
    e_dtype = st.log_prob.dtype
    step = _make_window_step(t.value_and_grad_fn, 0.5, jnp.ones(D, q0.dtype),
                             8, 1000.0, e_dtype)
    ps0 = _init_pstate(st.position, jnp.asarray(st.log_prob, e_dtype),
                       st.grad_log_prob, e_dtype)

    key = random.PRNGKey(7)
    kp, kd, kd2, ks, ku = random.split(key, 5)
    base = (random.normal(kp, (n_iters, C, D), q0.dtype),
            random.bernoulli(kd, 0.5, (n_iters, C)),
            random.bernoulli(kd2, 0.5, (n_iters, C)),
            random.uniform(ks, (n_iters, C)),
            random.uniform(ku, (n_iters, C), dtype=jnp.float32,
                           minval=jnp.finfo(jnp.float32).tiny))

    # res_u == 0: EVERY completion replaces the reservoir -> reservoir ==
    # the chain's final completed state (== ps.q, which only changes on term)
    xs_always = base + (jnp.zeros((n_iters, C)),)
    ps = lax.scan(step, ps0, xs_always)[0]
    assert int(ps.k_res.min()) >= 1  # every chain completed something
    np.testing.assert_array_equal(np.asarray(ps.q_res), np.asarray(ps.q))
    np.testing.assert_array_equal(np.asarray(ps.lp_res), np.asarray(ps.lp))

    # res_u == 1: only the FIRST completion is kept (1 * u < 1 fails for
    # k >= 1 except k == 0 -> only k=1 passes via 1*1<1? no: u=1, k=1 ->
    # 1 >= 1 fails too) -> reservoir never replaced, stays the init state
    xs_never = base + (jnp.ones((n_iters, C)),)
    ps2 = lax.scan(step, ps0, xs_never)[0]
    np.testing.assert_array_equal(np.asarray(ps2.q_res), np.asarray(q0))
    # identical trajectories either way: res_u must not affect the machine
    np.testing.assert_array_equal(np.asarray(ps2.q), np.asarray(ps.q))
    np.testing.assert_array_equal(np.asarray(ps2.transitions),
                                  np.asarray(ps.transitions))


def test_snapshot_uniform_reduces_occupancy_bias():
    """'uniform' snapshots must not be FARTHER from the truth than 'last'
    (deterministic-time) snapshots: on the standard normal the 'last' mode
    is length-biased low (module docstring), and 'uniform' recovers most
    of it at window sizes >~ the mean transition length."""
    t = standard_normal(4)
    init = random.normal(random.PRNGKey(5), (64, 4)) * 0.3
    out = {}
    for mode in ("uniform", "last"):
        r = nuts_run_persistent(random.PRNGKey(7), t.log_prob_fn, init,
                                step_size=0.5, num_samples=200,
                                steps_per_sample=64, burn_in_steps=128,
                                max_tree_depth=8, snapshot_mode=mode,
                                value_and_grad_fn=t.value_and_grad_fn)
        out[mode] = np.asarray(r.samples).reshape(-1, 4).var(0).mean()
    # measured at 4x this budget: last ~0.954, uniform ~0.963 (classic
    # reference-parity gives ~0.967); allow generous noise margins but pin
    # the ordering direction
    assert out["uniform"] > out["last"] - 0.005, out
    assert out["uniform"] > 0.93, out


def test_multinomial_scheme_recovers_exact_variance():
    """proposal_scheme='multinomial' (per-leaf progressive weighting + the
    full iterative sub-U-turn check set — Stan semantics) removes the
    endpoint scheme's measured underdispersion: marginal variance ~1.00
    where the reference-parity endpoint scheme reads ~0.96 at the same
    budget (BASELINE.md bias audit). Deterministic given the keys."""
    t = standard_normal(4)
    init = random.normal(random.PRNGKey(5), (64, 4)) * 0.3
    out = {}
    for scheme in ("endpoint", "multinomial"):
        r = nuts_run_persistent(random.PRNGKey(7), t.log_prob_fn, init,
                                step_size=0.5, num_samples=800,
                                steps_per_sample=64, burn_in_steps=256,
                                max_tree_depth=8,
                                value_and_grad_fn=t.value_and_grad_fn,
                                proposal_scheme=scheme)
        m = np.asarray(r.samples).reshape(-1, 4)
        out[scheme] = float(m.var(0).mean())
        assert np.all(np.isfinite(np.asarray(r.samples)))
    # measured: endpoint 0.960, multinomial 0.997 at these keys
    assert 0.97 < out["multinomial"] < 1.03, out
    assert out["endpoint"] < out["multinomial"], out


def test_multinomial_scheme_backend_rules():
    """multinomial runs under both snapshot modes; unknown schemes
    raise."""
    t = standard_normal(4)
    init = random.normal(random.PRNGKey(1), (8, 4)) * 0.1
    for snapshot_mode in ("uniform", "last"):
        res = nuts_run_persistent(random.PRNGKey(0), t.log_prob_fn, init,
                                  step_size=0.5, num_samples=4,
                                  steps_per_sample=8,
                                  snapshot_mode=snapshot_mode,
                                  value_and_grad_fn=t.value_and_grad_fn,
                                  proposal_scheme="multinomial")
        assert res.samples.shape == (4, 8, 4)
        assert np.all(np.isfinite(np.asarray(res.samples)))
    with pytest.raises(ValueError, match="proposal_scheme"):
        nuts_run_persistent(random.PRNGKey(0), t.log_prob_fn, init,
                            step_size=0.5, num_samples=4,
                            steps_per_sample=8,
                            value_and_grad_fn=t.value_and_grad_fn,
                            proposal_scheme="bogus")


def test_multinomial_scheme_with_dense_metric():
    """Dense (D, D) metric composes with the multinomial scheme: oracle
    metric on a correlated Gaussian recovers the true moments."""
    from mcmc_tpu.targets import correlated_gaussian
    t = correlated_gaussian(6, correlation=0.9)
    init = random.normal(random.PRNGKey(3), (64, 6))
    r = nuts_run_persistent(random.PRNGKey(9), t.log_prob_fn, init,
                            step_size=0.5, num_samples=400,
                            steps_per_sample=32, burn_in_steps=128,
                            inv_mass_matrix=jnp.asarray(t.true_cov),
                            value_and_grad_fn=t.value_and_grad_fn,
                            proposal_scheme="multinomial")
    m = np.asarray(r.samples).reshape(-1, 6)
    emp = np.cov(m.T)
    assert np.abs(emp - np.asarray(t.true_cov)).max() < 0.12, emp


def test_leapfrog_counter_dtype_survives_huge_slot_totals():
    """Regression pin (round 5): uint32 slot counters saturate at 4.29e9;
    a 1024-chain x 10k-snapshot x 512-steps/snapshot run (the window-bias
    probe) must trace without OverflowError, with the counter dtype
    degrading to f32 only beyond the exact-uint32 range. Trace-only via
    eval_shape — no sampling runs."""
    t = standard_normal(4)
    init_small = jax.ShapeDtypeStruct((64, 4), jnp.float32)

    def shapes(num_samples, steps_per_sample, n_chains):
        return jax.eval_shape(
            lambda key, pos: nuts_run_persistent(
                key, t.log_prob_fn, pos, step_size=0.5,
                num_samples=num_samples, steps_per_sample=steps_per_sample,
                value_and_grad_fn=t.value_and_grad_fn),
            jax.ShapeDtypeStruct((2,), jnp.uint32),
            jax.ShapeDtypeStruct((n_chains, 4), jnp.float32))

    # note: the suite runs under x64, where counters are int64 regardless
    small = shapes(8, 16, 64)
    big = shapes(10000, 512, 1024)       # 5.24e9 slots > uint32 range
    if jax.config.jax_enable_x64:
        assert small.info["n_leapfrog_slots"].dtype == jnp.int64
        assert big.info["n_leapfrog_slots"].dtype == jnp.int64
    else:
        assert small.info["n_leapfrog_slots"].dtype == jnp.uint32
        assert big.info["n_leapfrog_slots"].dtype == jnp.float32
    assert big.info["n_leapfrogs_per_chain"].shape == (1024,)
