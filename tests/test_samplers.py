"""Sampler tests: shapes/mechanics + statistical correctness on analytic targets.

Statistical acceptance follows the reference's own runtime gates (SURVEY.md §4):
R-hat, moment z-checks against closed-form true_mean/true_cov.
"""

import jax
import jax.numpy as jnp
import jax.random as random
import numpy as np
import pytest

from mcmc_tpu.targets import standard_normal, ill_conditioned_gaussian, neals_funnel
from mcmc_tpu.samplers import (
    rwmh_run, hmc_run, nuts_run, grahmc_run,
    get_friction_schedule, FRICTION_SCHEDULES, leapfrog, hmc_init,
)
from mcmc_tpu.diagnostics import split_rhat


TARGET = standard_normal(5)
N_CHAINS = 8


def _init(key, n_chains=N_CHAINS, dim=5, spread=1.0):
    return random.normal(key, (n_chains, dim)) * spread


def _check_moments(samples, true_mean, true_var, tol_mean=0.15, tol_var=0.25):
    flat = np.asarray(samples).reshape(-1, samples.shape[-1])
    mean = flat.mean(axis=0)
    var = flat.var(axis=0)
    assert np.all(np.abs(mean - true_mean) < tol_mean), mean
    assert np.all(np.abs(var / true_var - 1.0) < tol_var), var


# ----------------------------------------------------------------------------
# RWMH
# ----------------------------------------------------------------------------

def test_rwmh_shapes_and_moments():
    res = rwmh_run(random.PRNGKey(0), TARGET.log_prob_fn,
                   _init(random.PRNGKey(1)), num_samples=4000,
                   scale=2.38 / np.sqrt(5), burn_in=500)
    assert res.samples.shape == (4000, N_CHAINS, 5)
    assert res.log_probs.shape == (4000, N_CHAINS)
    assert res.accept_rate.shape == (N_CHAINS,)
    assert 0.1 < float(res.accept_rate.mean()) < 0.5
    _check_moments(res.samples, 0.0, 1.0)
    assert float(jnp.max(split_rhat(res.samples))) < 1.05


def test_rwmh_burn_in_resets_counter():
    res = rwmh_run(random.PRNGKey(0), TARGET.log_prob_fn,
                   _init(random.PRNGKey(1)), num_samples=100, scale=1.0,
                   burn_in=100)
    # accept_rate computed over sampling phase only
    assert np.all(np.asarray(res.accept_rate) <= 1.0)


def test_rwmh_log_prob_dtype_is_energy_dtype():
    res = rwmh_run(random.PRNGKey(0), TARGET.log_prob_fn,
                   _init(random.PRNGKey(1)), num_samples=10, scale=1.0)
    assert res.log_probs.dtype == jnp.float64  # x64 on in tests


# ----------------------------------------------------------------------------
# HMC
# ----------------------------------------------------------------------------

def test_hmc_moments_standard_normal():
    res = hmc_run(random.PRNGKey(2), TARGET.log_prob_fn,
                  _init(random.PRNGKey(3)), step_size=0.25, num_steps=8,
                  num_samples=2000, burn_in=300,
                  value_and_grad_fn=TARGET.value_and_grad_fn)
    assert float(res.accept_rate.mean()) > 0.6
    _check_moments(res.samples, 0.0, 1.0)
    assert float(jnp.max(split_rhat(res.samples))) < 1.05
    assert float(res.info["divergence_rate"]) < 0.01


def test_hmc_autodiff_fallback_matches_analytic():
    """Same keys, with and without analytic grads -> identical chains."""
    kw = dict(step_size=0.25, num_steps=5, num_samples=50, burn_in=0)
    r1 = hmc_run(random.PRNGKey(4), TARGET.log_prob_fn, _init(random.PRNGKey(5)),
                 value_and_grad_fn=TARGET.value_and_grad_fn, **kw)
    r2 = hmc_run(random.PRNGKey(4), TARGET.log_prob_fn, _init(random.PRNGKey(5)),
                 value_and_grad_fn=None, **kw)
    np.testing.assert_allclose(np.asarray(r1.samples), np.asarray(r2.samples),
                               rtol=1e-8, atol=1e-10)


def test_hmc_mass_matrix_ill_conditioned():
    """With the true inverse mass, an ill-conditioned Gaussian mixes well."""
    t = ill_conditioned_gaussian(6, condition_number=100.0)
    inv_mass = jnp.linspace(1.0, 100.0, 6)  # = target variances
    res = hmc_run(random.PRNGKey(6), t.log_prob_fn, _init(random.PRNGKey(7), dim=6),
                  step_size=0.5, num_steps=10, num_samples=2500, burn_in=500,
                  inv_mass_matrix=inv_mass, value_and_grad_fn=t.value_and_grad_fn)
    _check_moments(res.samples, np.zeros(6), np.linspace(1.0, 100.0, 6),
                   tol_mean=1.2, tol_var=0.3)
    assert float(jnp.max(split_rhat(res.samples))) < 1.05


def test_hmc_energy_conservation_small_step():
    """Tiny step size -> near-perfect acceptance (leapfrog sanity)."""
    res = hmc_run(random.PRNGKey(8), TARGET.log_prob_fn,
                  _init(random.PRNGKey(9)), step_size=0.01, num_steps=10,
                  num_samples=100, burn_in=0,
                  value_and_grad_fn=TARGET.value_and_grad_fn)
    assert float(res.accept_rate.mean()) > 0.99


def test_hmc_divergence_counted_on_blowup():
    """Huge step size on ill-conditioned target -> divergences reported."""
    t = ill_conditioned_gaussian(6, condition_number=100.0)
    res = hmc_run(random.PRNGKey(10), t.log_prob_fn,
                  _init(random.PRNGKey(11), dim=6), step_size=5.0, num_steps=20,
                  num_samples=200, burn_in=0, value_and_grad_fn=t.value_and_grad_fn)
    assert float(res.accept_rate.mean()) < 0.2
    assert float(res.info["divergence_rate"]) > 0.0


def test_hmc_track_proposals():
    res = hmc_run(random.PRNGKey(12), TARGET.log_prob_fn,
                  _init(random.PRNGKey(13)), step_size=0.3, num_steps=5,
                  num_samples=60, burn_in=0, track_proposals=True,
                  value_and_grad_fn=TARGET.value_and_grad_fn)
    assert res.info["proposal_positions"].shape == (60, N_CHAINS, 5)
    assert res.info["delta_H"].shape == (60, N_CHAINS)


def test_hmc_collect_chains_prefix():
    res = hmc_run(random.PRNGKey(14), TARGET.log_prob_fn,
                  _init(random.PRNGKey(15)), step_size=0.3, num_steps=5,
                  num_samples=20, burn_in=0, collect_chains=2,
                  value_and_grad_fn=TARGET.value_and_grad_fn)
    assert res.samples.shape == (20, 2, 5)
    assert res.accept_rate.shape == (N_CHAINS,)  # stats still over all chains


def test_leapfrog_reversibility():
    """Integrate forward then backward -> original phase point."""
    state = hmc_init(_init(random.PRNGKey(16)), TARGET.log_prob_fn,
                     TARGET.value_and_grad_fn)
    p0 = random.normal(random.PRNGKey(17), state.position.shape)
    inv_mass = jnp.ones(5)
    q1, p1, lp1, g1 = leapfrog(state.position, p0, state.log_prob,
                               state.grad_log_prob, TARGET.value_and_grad_fn,
                               0.1, 20, inv_mass)
    q2, p2, _, _ = leapfrog(q1, -p1, lp1, g1, TARGET.value_and_grad_fn,
                            0.1, 20, inv_mass)
    np.testing.assert_allclose(np.asarray(q2), np.asarray(state.position),
                               atol=1e-8)
    np.testing.assert_allclose(np.asarray(-p2), np.asarray(p0), atol=1e-8)


# ----------------------------------------------------------------------------
# GRAHMC
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", list(FRICTION_SCHEDULES))
def test_grahmc_all_schedules_sample_correctly(schedule):
    res = grahmc_run(random.PRNGKey(18), TARGET.log_prob_fn,
                     _init(random.PRNGKey(19)), step_size=0.2, num_steps=10,
                     gamma=0.5, steepness=2.0, num_samples=1500, burn_in=300,
                     friction_schedule=get_friction_schedule(schedule),
                     value_and_grad_fn=TARGET.value_and_grad_fn)
    assert float(res.accept_rate.mean()) > 0.3, schedule
    _check_moments(res.samples, 0.0, 1.0, tol_mean=0.2, tol_var=0.3)


def test_grahmc_gamma_zero_equals_hmc():
    """gamma=0 conformal leapfrog == plain leapfrog, bitwise on same keys."""
    kw = dict(step_size=0.25, num_steps=8, num_samples=40, burn_in=0,
              value_and_grad_fn=TARGET.value_and_grad_fn)
    r_h = hmc_run(random.PRNGKey(20), TARGET.log_prob_fn,
                  _init(random.PRNGKey(21)), **kw)
    r_g = grahmc_run(random.PRNGKey(20), TARGET.log_prob_fn,
                     _init(random.PRNGKey(21)), gamma=0.0, steepness=1.0, **kw)
    np.testing.assert_allclose(np.asarray(r_h.samples), np.asarray(r_g.samples),
                               rtol=1e-12)


def test_grahmc_friction_schedules_values():
    """Schedule shapes: antisymmetric around T/2, range [-g, +g]."""
    T, g = 1.0, 2.0
    for name, fn in FRICTION_SCHEDULES.items():
        steep = {"tanh": 5.0, "sigmoid": 10.0}.get(name, 1.0)
        early = float(fn(0.0, T, g, steep))
        late = float(fn(T, T, g, steep))
        assert early < 0 <= late or (name == "sine" and abs(early + g) < 1e-6), name
        assert -g - 1e-6 <= early and late <= g + 1e-6, name
    # constant: exact step around T/2, and 0 AT T/2 so odd-length
    # trajectories on the midpoint grid stay volume-neutral
    cs = FRICTION_SCHEDULES["constant"]
    assert float(cs(0.49, 1.0, g, None)) == -g
    assert float(cs(0.5, 1.0, g, None)) == 0.0
    assert float(cs(0.51, 1.0, g, None)) == g


@pytest.mark.parametrize("schedule,num_steps",
                         [("tanh", 8), ("sine", 8), ("linear", 8),
                          ("constant", 7)])
def test_grahmc_kernel_invariance_aggressive(schedule, num_steps):
    """The GRAHMC transition must leave the target EXACTLY invariant even
    at aggressive (eps, gamma): start 32k chains from exact N(0, I) draws,
    run 60 transitions, and require the stationary variance to stay 1.

    This is the regression test for the friction-grid bias: evaluating the
    schedule at t = i*eps (the reference's grid, GRAHMC.py:246-252) makes
    the discrete friction sum -gamma_max instead of 0, expanding phase
    volume e^{+eps*gamma*D} per trajectory with no Jacobian in the MH test
    — measured var 4.33 (tanh), 4.42 (sine), 3.13 (linear) at this exact
    configuration before the midpoint-grid fix. MC error at 32k chains is
    ~0.8%; the 6% tolerance is 50x smaller than the bug's signal.
    ('constant' runs at odd L to pin the zero-at-T/2 refinement.)"""
    D, C = 3, 32768
    lp = lambda x: -0.5 * jnp.sum(x * x, axis=-1)
    vag = lambda x: (lp(x), -x)
    q0 = random.normal(random.PRNGKey(0), (C, D))
    res = grahmc_run(random.PRNGKey(1), lp, q0, step_size=0.5,
                     num_steps=num_steps, gamma=0.5, steepness=5.0,
                     num_samples=60, burn_in=0, collect_chains=1,
                     friction_schedule=get_friction_schedule(schedule),
                     value_and_grad_fn=vag)
    var = np.asarray(res.final_state.position).var(axis=0)
    np.testing.assert_allclose(var, 1.0, atol=0.06)
    assert float(res.accept_rate.mean()) > 0.5


def test_grahmc_on_funnel_runs():
    t = neals_funnel(5)
    res = grahmc_run(random.PRNGKey(22), t.log_prob_fn,
                     t.init_sampler(random.PRNGKey(23), N_CHAINS),
                     step_size=0.1, num_steps=10, gamma=1.0, steepness=0.5,
                     num_samples=300, burn_in=100,
                     friction_schedule=get_friction_schedule("tanh"),
                     value_and_grad_fn=t.value_and_grad_fn)
    assert np.all(np.isfinite(np.asarray(res.samples)))


# ----------------------------------------------------------------------------
# NUTS
# ----------------------------------------------------------------------------

def test_nuts_moments_standard_normal():
    res = nuts_run(random.PRNGKey(24), TARGET.log_prob_fn,
                   _init(random.PRNGKey(25)), step_size=0.4,
                   num_samples=1500, burn_in=200,
                   value_and_grad_fn=TARGET.value_and_grad_fn)
    _check_moments(res.samples, 0.0, 1.0, tol_mean=0.2, tol_var=0.3)
    assert float(jnp.max(split_rhat(res.samples))) < 1.05
    depths = np.asarray(res.info["tree_depths"])
    assert depths.shape == (1500, N_CHAINS)
    assert depths.max() <= 10
    alphas = np.asarray(res.info["mean_accept_probs"])
    assert np.all((alphas >= 0) & (alphas <= 1))


def test_nuts_adapts_tree_depth_to_step_size():
    """Smaller step -> deeper trees (more steps to reach the U-turn)."""
    r_small = nuts_run(random.PRNGKey(26), TARGET.log_prob_fn,
                       _init(random.PRNGKey(27)), step_size=0.05,
                       num_samples=50, burn_in=20,
                       value_and_grad_fn=TARGET.value_and_grad_fn)
    r_big = nuts_run(random.PRNGKey(26), TARGET.log_prob_fn,
                     _init(random.PRNGKey(27)), step_size=0.8,
                     num_samples=50, burn_in=20,
                     value_and_grad_fn=TARGET.value_and_grad_fn)
    assert (np.asarray(r_small.info["tree_depths"]).mean()
            > np.asarray(r_big.info["tree_depths"]).mean() + 1)


def test_nuts_respects_max_tree_depth():
    res = nuts_run(random.PRNGKey(28), TARGET.log_prob_fn,
                   _init(random.PRNGKey(29)), step_size=0.01,
                   num_samples=20, burn_in=0, max_tree_depth=4,
                   value_and_grad_fn=TARGET.value_and_grad_fn)
    assert np.asarray(res.info["tree_depths"]).max() <= 4


def test_nuts_funnel_with_mass_matrix():
    t = neals_funnel(5)
    res = nuts_run(random.PRNGKey(30), t.log_prob_fn,
                   t.init_sampler(random.PRNGKey(31), N_CHAINS),
                   step_size=0.2, num_samples=400, burn_in=200,
                   inv_mass_matrix=jnp.asarray(np.diag(np.asarray(t.true_cov))),
                   value_and_grad_fn=t.value_and_grad_fn)
    assert np.all(np.isfinite(np.asarray(res.samples)))
    assert float(res.info["divergence_rate"]) < 0.2


@pytest.mark.parametrize("backend", ["xla", "interpret"])
def test_nonfinite_proposals_rejected_from_high_energy_states(backend):
    """A chain far out in the tails (energy above the 1e10 guard value)
    must still reject a proposal whose Hamiltonian overflows: otherwise
    the guard value alone is 'downhill' and a NaN/inf state is accepted,
    which is absorbing."""
    from mcmc_tpu.samplers import hmc_run
    t = standard_normal(4)
    init = jnp.full((16, 4), 1e12, jnp.float32)      # h0 ~ 2e24 > 1e10
    res = hmc_run(random.PRNGKey(0), t.log_prob_fn, init, step_size=1e30,
                  num_steps=4, num_samples=3,
                  value_and_grad_fn=t.value_and_grad_fn, backend=backend)
    assert np.all(np.isfinite(np.asarray(res.final_state.position)))
    assert np.all(np.asarray(res.final_state.position) == 1e12)
    assert float(res.accept_rate.max()) == 0.0


# Seeds whose accept draw over 1,024 chains holds an exact float32 zero:
# PRNGKey(11195) through grahmc_step's key split, PRNGKey(703) through the
# fused kernel step's (found by search; the test asserts it).
@pytest.mark.parametrize("backend,seed", [("xla", 11195), ("interpret", 703)])
def test_zero_uniform_draw_cannot_accept_a_runaway_proposal(backend, seed):
    """random.uniform returns exactly 0 with probability 2^-23 per float32
    draw, and log(0) = -inf accepts any finite proposal. A float32 HMC
    warmup on the 10D correlated Gaussian (L=16, ~10^7 accept draws) sent
    one chain to |q| ~ 1e15 that way and learned a 1e21 mass matrix. With
    the draw floored above 0 (precision.accept_uniform), an unstable step
    (eps * omega = 3 > 2: |q| grows ~1e13 over 16 steps, H stays finite)
    is rejected on every chain."""
    from mcmc_tpu.ops.fused_trajectory import make_fused_grahmc_step
    from mcmc_tpu.samplers.base import ChainState
    from mcmc_tpu.samplers.grahmc import grahmc_step

    n, d, num_steps, eps = 1024, 4, 16, 3.0
    t = standard_normal(d)
    if backend == "xla":
        k_acc = random.split(random.PRNGKey(seed), 3)[2]
    else:
        k_acc = random.split(random.split(random.PRNGKey(seed))[1])[1]
    assert float(random.uniform(k_acc, (n,), jnp.float32).min()) == 0.0

    q = random.normal(random.PRNGKey(1), (n, d), jnp.float32)
    lp, grad = t.value_and_grad_fn(q)
    state = ChainState(q, lp.astype(jnp.float32), grad.astype(jnp.float32),
                       jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32))
    inv_mass = jnp.ones(d, jnp.float32)
    if backend == "xla":
        _, new, (accept, prop_q, _, _) = grahmc_step(
            random.PRNGKey(seed), state, t.value_and_grad_fn, eps,
            num_steps, 0.0, 1.0, inv_mass, None)
    else:
        fused = make_fused_grahmc_step(t.log_prob_fn, t.value_and_grad_fn,
                                       num_steps, None, backend="interpret")
        _, new, (accept, prop_q, _, _) = fused(
            random.PRNGKey(seed), state, eps, 0.0, 1.0, inv_mass)
    assert float(jnp.abs(prop_q).max()) > 1e6       # the proposals ran away
    assert not bool(jnp.any(accept))
    np.testing.assert_array_equal(np.asarray(new.position), np.asarray(q))
