"""Parallel tempering / replica exchange (samplers/tempered.py).

The headline test pins the capability the plain samplers lack: on the
bimodal gaussian_mixture with a 5-sigma barrier (separation=10), HMC chains
initialized in one mode NEVER cross (the documented all-target-soak failure
mode; the reference works around it with a split-mode init_sampler,
reference benchmarks/targets.py:456-465), while the tempered ladder
recovers both modes and the exact moments.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import jax.random as random

from mcmc_tpu.samplers import (geometric_ladder, hmc_run, tempered_run)
from mcmc_tpu.samplers.grahmc import tanh_schedule
from mcmc_tpu.targets import gaussian_mixture, standard_normal


def test_geometric_ladder():
    b = np.asarray(geometric_ladder(6, 0.05))
    assert b.shape == (6,)
    assert b[0] == 1.0 and abs(b[-1] - 0.05) < 1e-6
    assert np.all(np.diff(b) < 0)                      # strictly descending
    ratios = b[1:] / b[:-1]
    np.testing.assert_allclose(ratios, ratios[0], rtol=1e-5)   # geometric
    np.testing.assert_array_equal(np.asarray(geometric_ladder(1)), [1.0])
    with pytest.raises(ValueError, match="beta_min"):
        geometric_ladder(4, 1.5)
    with pytest.raises(ValueError, match="n_temps"):
        geometric_ladder(0)


def test_swap_attempts_accounting():
    """info['swap_attempts'] counts per-pair attempt EVENTS (chains x swap
    phases). With swap_interval=1 every pair is attempted on alternate
    transitions; a burst shorter than one full even/odd cycle leaves the
    odd pairs at exactly ZERO — the signal tuning/ladder.py uses to
    reject mis-sized tuning bursts (a rate of 0 alone is indistinguishable
    from always-rejected)."""
    t = standard_normal(3)
    init = random.normal(random.PRNGKey(1), (8, 3)) * 0.2
    kw = dict(step_size=0.5, num_steps=4, n_temps=4, beta_min=0.05,
              value_and_grad_fn=t.value_and_grad_fn)
    r = tempered_run(random.PRNGKey(0), t.log_prob_fn, init,
                     num_samples=10, **kw)
    # 10 transitions, swap every step, parity alternates: 5 phases each
    np.testing.assert_array_equal(np.asarray(r.info["swap_attempts"]),
                                  [40.0, 40.0, 40.0])
    r2 = tempered_run(random.PRNGKey(0), t.log_prob_fn, init,
                      num_samples=16, swap_interval=16, **kw)
    # one swap phase (it=15, phase 0): even pairs once, odd pair NEVER
    np.testing.assert_array_equal(np.asarray(r2.info["swap_attempts"]),
                                  [8.0, 0.0, 8.0])
    assert float(np.asarray(r2.info["swap_accept_rate"])[1]) == 0.0


def test_tempered_run_rejects_bad_betas():
    """A bad explicit ladder errors loudly instead of silently emitting
    pi^beta_0 draws labeled as untempered (betas[0] != 1), NaNing the
    swap phase (beta <= 0), or breaking the descending-ladder invariant
    every downstream formula assumes."""
    t = standard_normal(3)
    init = random.normal(random.PRNGKey(1), (4, 3)) * 0.2
    kw = dict(step_size=0.5, num_steps=4, num_samples=4,
              value_and_grad_fn=t.value_and_grad_fn)
    with pytest.raises(ValueError, match=r"betas\[0\] must be 1"):
        tempered_run(random.PRNGKey(0), t.log_prob_fn, init,
                     betas=jnp.asarray([0.9, 0.3, 0.1]), **kw)
    with pytest.raises(ValueError, match="strictly positive"):
        tempered_run(random.PRNGKey(0), t.log_prob_fn, init,
                     betas=jnp.asarray([1.0, 0.5, 0.0]), **kw)
    with pytest.raises(ValueError, match="descending"):
        tempered_run(random.PRNGKey(0), t.log_prob_fn, init,
                     betas=jnp.asarray([1.0, 0.5, 0.5]), **kw)
    with pytest.raises(ValueError, match="1-D"):
        tempered_run(random.PRNGKey(0), t.log_prob_fn, init,
                     betas=jnp.ones((2, 2)), **kw)


def test_tempered_normal_moments_and_schema():
    """Exchange moves preserve the product measure: the cold replica's
    marginals on N(0, I) stay exact, and the info schema carries the
    ladder diagnostics."""
    t = standard_normal(4)
    init = random.normal(random.PRNGKey(1), (16, 4)) * 0.2
    r = tempered_run(random.PRNGKey(0), t.log_prob_fn, init, step_size=0.5,
                     num_steps=8, num_samples=600, burn_in=100, n_temps=4,
                     value_and_grad_fn=t.value_and_grad_fn)
    assert r.samples.shape == (600, 16, 4)
    assert r.log_probs.shape == (600, 16)
    m = np.asarray(r.samples).reshape(-1, 4)
    assert np.all(np.abs(m.mean(0)) < 0.12)
    assert np.all(np.abs(m.var(0) - 1.0) < 0.15)
    # emitted log-probs are the UNtempered target's at the emitted states
    lp_expect = np.asarray(t.log_prob_fn(jnp.asarray(m[-16:])))
    np.testing.assert_allclose(np.asarray(r.log_probs[-1]), lp_expect,
                               rtol=1e-4, atol=1e-4)
    sw = np.asarray(r.info["swap_accept_rate"])
    assert sw.shape == (3,)
    assert np.all((sw > 0.05) & (sw < 1.0))            # live, healthy ladder
    assert np.asarray(r.info["betas"]).shape == (4,)
    assert np.asarray(r.info["replica_step_sizes"]).shape == (4,)
    acc = np.asarray(r.info["replica_accept_rate"])
    assert acc.shape == (4,) and np.all((acc > 0.3) & (acc <= 1.0))
    assert r.final_state.position.shape == (16, 4)


@pytest.mark.slow
def test_tempered_mixture_crosses_where_hmc_cannot():
    """5-sigma barrier (separation=10, modes at +-5), ALL chains started in
    the LEFT mode: plain HMC's mode fraction stays 0 (measured mean -5.01)
    while the tempered ladder recovers both modes and Var[x0] = 1 + 25."""
    t = gaussian_mixture(4, separation=10.0)
    init = random.normal(random.PRNGKey(2), (16, 4)) * 0.3
    init = init.at[:, 0].add(-5.0)

    rh = hmc_run(random.PRNGKey(3), t.log_prob_fn, init, step_size=0.3,
                 num_steps=16, num_samples=800, burn_in=200,
                 value_and_grad_fn=t.value_and_grad_fn)
    x0_h = np.asarray(rh.samples)[..., 0].reshape(-1)
    # heavily stuck in the left mode (a few chains cross under x64 at this
    # budget, so assert the gross asymmetry rather than zero crossings)
    assert (x0_h > 0).mean() < 0.15
    assert x0_h.mean() < -3.5

    rt = tempered_run(random.PRNGKey(3), t.log_prob_fn, init, step_size=0.3,
                      num_steps=16, num_samples=800, burn_in=200, n_temps=6,
                      beta_min=0.01, value_and_grad_fn=t.value_and_grad_fn)
    x0_t = np.asarray(rt.samples)[..., 0].reshape(-1)
    frac_right = (x0_t > 0).mean()
    assert 0.4 < frac_right < 0.6, frac_right          # both modes visited
    assert abs(x0_t.mean()) < 0.6
    assert abs(x0_t.var() - 26.0) < 3.0                # Var = 1 + (sep/2)^2
    sw = np.asarray(rt.info["swap_accept_rate"])
    assert np.all(sw > 0.1), sw


def test_single_temperature_is_plain_sampling():
    """K=1 degrades to plain (tempering-free) HMC: no swap machinery, same
    statistical behavior."""
    t = standard_normal(3)
    init = random.normal(random.PRNGKey(1), (8, 3)) * 0.2
    r = tempered_run(random.PRNGKey(0), t.log_prob_fn, init, step_size=0.5,
                     num_steps=8, num_samples=300, burn_in=50, n_temps=1,
                     value_and_grad_fn=t.value_and_grad_fn)
    assert r.samples.shape == (300, 8, 3)
    assert np.asarray(r.info["swap_accept_rate"]).shape == (0,)
    m = np.asarray(r.samples).reshape(-1, 3)
    assert np.all(np.abs(m.var(0) - 1.0) < 0.25)


def test_tempered_grahmc_friction_and_explicit_ladder():
    """Friction schedules (GRAHMC) and explicit betas / per-replica step
    sizes compose; collect_chains truncates the emitted prefix."""
    t = standard_normal(3)
    init = random.normal(random.PRNGKey(1), (8, 3)) * 0.2
    betas = jnp.asarray([1.0, 0.3, 0.1], jnp.float32)
    # friction (gamma=1, steepness=5) needs smaller steps than plain HMC:
    # step 0.4 at L=8 collapses acceptance to ~0.05 on PLAIN grahmc too
    steps = jnp.asarray([0.15, 0.25, 0.4], jnp.float32)
    r = tempered_run(random.PRNGKey(0), t.log_prob_fn, init, step_size=steps,
                     num_steps=8, num_samples=500, burn_in=100, betas=betas,
                     gamma=1.0, steepness=5.0, friction_schedule=tanh_schedule,
                     swap_interval=2, collect_chains=4,
                     value_and_grad_fn=t.value_and_grad_fn)
    assert r.samples.shape == (500, 4, 3)
    np.testing.assert_array_equal(np.asarray(r.info["replica_step_sizes"]),
                                  np.asarray(steps))
    m = np.asarray(r.samples).reshape(-1, 3)
    assert np.all(np.isfinite(m))
    # 4 correlated chains x 500 draws: loose moment check only
    assert np.all(np.abs(m.var(0) - 1.0) < 0.35)
    assert np.all(np.abs(m.mean(0)) < 0.25)


def test_tempered_pallas_backend_moments_match_xla():
    """The kernel backend runs every replica through ONE compiled fused
    trajectory kernel (scalar (eps_k, beta_k) per call via the static-gated
    lp_scale, ops/fused_trajectory.py) — same physics as the XLA path: the
    cold marginals stay exact and the ladder diagnostics agree. On CPU the
    kernel runs under the interpreter (backend='interpret'); its key
    splits differ from the XLA scan's, so the comparison is statistical."""
    t = standard_normal(4)
    init = random.normal(random.PRNGKey(1), (64, 4)) * 0.2
    kw = dict(step_size=0.5, num_steps=8, num_samples=400, burn_in=100,
              n_temps=4, value_and_grad_fn=t.value_and_grad_fn)
    rx = tempered_run(random.PRNGKey(0), t.log_prob_fn, init,
                      backend="xla", **kw)
    rp = tempered_run(random.PRNGKey(0), t.log_prob_fn, init,
                      backend="interpret", **kw)
    mx = np.asarray(rx.samples).reshape(-1, 4)
    mp = np.asarray(rp.samples).reshape(-1, 4)
    assert np.all(np.abs(mp.var(0) - 1.0) < 0.15)
    assert np.all(np.abs(mp.mean(0)) < 0.12)
    assert abs(float(rp.accept_rate.mean()) - float(rx.accept_rate.mean())) < 0.05
    swx = np.asarray(rx.info["swap_accept_rate"])
    swp = np.asarray(rp.info["swap_accept_rate"])
    assert np.all(np.abs(swx - swp) < 0.12), (swx, swp)


def test_tempered_replica_continuation():
    """info['replica_final_positions'] fed back as init_replica_position
    continues the FULL ladder: hot rungs keep their dispersed state (a cold
    restart would re-tile the cold positions, collapsing the hot rungs'
    overdispersion back to the cold marginal)."""
    t = standard_normal(4)
    init = random.normal(random.PRNGKey(1), (32, 4)) * 0.2
    kw = dict(step_size=0.5, num_steps=8, n_temps=4, beta_min=0.05,
              value_and_grad_fn=t.value_and_grad_fn)
    r1 = tempered_run(random.PRNGKey(0), t.log_prob_fn, init,
                      num_samples=300, burn_in=100, **kw)
    rep = r1.info["replica_final_positions"]
    assert rep.shape == (4 * 32, 4)
    # hottest replica (last C rows) samples pi^0.05 = N(0, 20): visibly
    # overdispersed vs the cold rows
    hot_var = float(np.asarray(rep[-32:]).var())
    cold_var = float(np.asarray(rep[:32]).var())
    assert hot_var > 4.0 * cold_var, (hot_var, cold_var)
    r2 = tempered_run(random.PRNGKey(5), t.log_prob_fn, init,
                      num_samples=300, init_replica_position=rep, **kw)
    rep2 = r2.info["replica_final_positions"]
    assert float(np.asarray(rep2[-32:]).var()) > 4.0 * float(
        np.asarray(rep2[:32]).var())
    m = np.asarray(r2.samples).reshape(-1, 4)
    assert np.all(np.abs(m.var(0) - 1.0) < 0.15)       # no re-burn-in needed
    with pytest.raises(ValueError, match="init_replica_position"):
        tempered_run(random.PRNGKey(0), t.log_prob_fn, init, num_samples=4,
                     init_replica_position=rep[:7], **kw)


def test_tempered_validation_errors():
    t = standard_normal(3)
    init = random.normal(random.PRNGKey(1), (4, 3)) * 0.2
    with pytest.raises(ValueError, match="swap_interval"):
        tempered_run(random.PRNGKey(0), t.log_prob_fn, init, step_size=0.5,
                     num_steps=4, num_samples=4, swap_interval=0,
                     value_and_grad_fn=t.value_and_grad_fn)
    with pytest.raises(ValueError, match="step_size"):
        tempered_run(random.PRNGKey(0), t.log_prob_fn, init,
                     step_size=jnp.ones(5), num_steps=4, num_samples=4,
                     n_temps=3, value_and_grad_fn=t.value_and_grad_fn)


def test_tempered_composes_with_unconstrained_reparam():
    """Round-5 composition (VERDICT r4 #8): replica exchange over the
    log-transformed gamma family. Every rung samples pi_y^beta of the
    UNCONSTRAINED density (Jacobian included), so the ladder is valid on
    all of R^D and the cold chain recovers expGamma moments with zero
    divergences — the constrained family diverges at every boundary
    crossing instead."""
    from scipy.special import digamma
    from mcmc_tpu.targets import get_target

    t = get_target("log_gamma_unconstrained", dim=4)
    init = t.init_sampler(random.PRNGKey(1), 8)
    r = tempered_run(random.PRNGKey(2), t.log_prob_fn, init,
                     step_size=0.3, num_steps=8, num_samples=1200,
                     burn_in=200, n_temps=3, beta_min=0.2,
                     value_and_grad_fn=t.value_and_grad_fn)
    assert int(r.info["total_divergences"]) == 0
    mean = np.asarray(r.samples).reshape(-1, 4).mean(axis=0)
    np.testing.assert_allclose(mean, np.full(4, digamma(2.0)), atol=0.15)
