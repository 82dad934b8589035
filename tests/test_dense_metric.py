"""Dense (full-covariance) metric support — a beyond-reference extension
matching Stan's dense_e (the reference implements the diagonal metric only,
reference tuning/adaptation.py:265). XLA samplers accept a (D, D)
inv_mass_matrix; the warmup learns it with pooled second moments; the fused
trajectory kernel takes the dense M^{-1} as an operand (one float32 pl.dot
per velocity) and its momenta are drawn outside with the L^{-1} factor."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import random

from mcmc_tpu.targets import correlated_gaussian, standard_normal
from mcmc_tpu.samplers.trajectory import (
    kinetic_energy, sample_momentum, velocity)


def test_dense_helpers_reduce_to_diagonal():
    """velocity/kinetic/momentum with diag(v) as a dense matrix must match
    the diagonal code path (the Cholesky of a diagonal matrix is its
    elementwise sqrt, so the triangular solve is the elementwise divide)."""
    v = jnp.linspace(0.5, 2.0, 6)
    dense = jnp.diag(v)
    p = random.normal(random.PRNGKey(0), (32, 6))
    np.testing.assert_allclose(velocity(p, dense), velocity(p, v), rtol=1e-6)
    np.testing.assert_allclose(kinetic_energy(p, dense),
                               kinetic_energy(p, v), rtol=1e-6)
    pd = sample_momentum(random.PRNGKey(1), (32, 6), dense, jnp.float64)
    pv = sample_momentum(random.PRNGKey(1), (32, 6), v, jnp.float64)
    np.testing.assert_allclose(pd, pv, rtol=1e-10)


def test_dense_momentum_covariance():
    """p ~ N(0, M) with M = inv_mass^{-1}: the sample covariance of many
    dense-metric momentum draws must match M."""
    rho = 0.8
    inv_mass = jnp.asarray([[1.0, rho], [rho, 1.0]])   # = Sigma estimate
    p = sample_momentum(random.PRNGKey(2), (200000, 2), inv_mass,
                        jnp.float64)
    emp = np.cov(np.asarray(p).T)
    M = np.linalg.inv(np.asarray(inv_mass))
    np.testing.assert_allclose(emp, M, atol=0.02)


def test_hmc_dense_oracle_metric_beats_diagonal():
    """On the rho=0.9 compound-symmetry Gaussian, HMC with the ORACLE dense
    metric (inv_mass = true Sigma, which whitens the target exactly) must
    (a) sample the correct moments and (b) deliver far more bulk ESS than
    the diagonal metric at the same (step, L) — the capability the
    reference cannot express at any tuning effort."""
    from mcmc_tpu.samplers import hmc_run
    from mcmc_tpu.diagnostics import ess_bulk

    dim = 6
    t = correlated_gaussian(dim, correlation=0.9)
    sigma = jnp.asarray(t.true_cov)
    init = random.normal(random.PRNGKey(0), (64, dim)) * 0.3

    kw = dict(step_size=0.7, num_steps=6, num_samples=800, burn_in=200,
              value_and_grad_fn=t.value_and_grad_fn)
    res_dense = hmc_run(random.PRNGKey(1), t.log_prob_fn, init,
                        inv_mass_matrix=sigma, **kw)
    res_diag = hmc_run(random.PRNGKey(1), t.log_prob_fn, init,
                       inv_mass_matrix=jnp.diag(sigma), **kw)

    s = np.asarray(res_dense.samples).reshape(-1, dim)
    emp = np.cov(s.T)
    np.testing.assert_allclose(emp, np.asarray(sigma), atol=0.12)
    assert abs(s.mean()) < 0.05

    ess_dense = float(jnp.min(ess_bulk(res_dense.samples)))
    ess_diag = float(jnp.min(ess_bulk(res_diag.samples)))
    # whitened dynamics decorrelate in a quarter period; the diagonal
    # metric leaves the rho=0.9 ridge (condition number ~ 1+rho*d ~ 5.5^2)
    assert ess_dense > 3 * ess_diag, (ess_dense, ess_diag)
    assert 0.5 < float(res_dense.accept_rate.mean()) <= 1.0


def test_grahmc_dense_runs_and_samples():
    """GRAHMC (tanh friction) with a dense metric keeps the posterior exact
    (conformal leapfrog + MH under any constant metric)."""
    from mcmc_tpu.samplers import grahmc_run, get_friction_schedule

    dim = 4
    t = correlated_gaussian(dim, correlation=0.9)
    init = random.normal(random.PRNGKey(3), (64, dim)) * 0.3
    # gentle friction: tanh with gamma=0.5/steepness=5 at eps=0.5 is a
    # known-bad operating point for ANY metric (acceptance collapses to
    # ~0.001 even with the identity metric on a standard normal — energy
    # injected by the repel phase explodes |dH|); the pipeline's ESJD
    # tuner exists to avoid exactly that region
    res = grahmc_run(random.PRNGKey(4), t.log_prob_fn, init, step_size=0.3,
                     num_steps=8, gamma=0.1, steepness=0.5, num_samples=600,
                     burn_in=150, inv_mass_matrix=jnp.asarray(t.true_cov),
                     friction_schedule=get_friction_schedule("tanh"),
                     value_and_grad_fn=t.value_and_grad_fn)
    s = np.asarray(res.samples).reshape(-1, dim)
    np.testing.assert_allclose(np.cov(s.T), np.asarray(t.true_cov),
                               atol=0.15)


@pytest.mark.parametrize("family", ["standard_normal", "neals_funnel"])
def test_fused_debug_dense_matches_xla(family):
    """Fused trajectory kernel with a DENSE metric == XLA trajectory math
    bit-for-bit at the accept decision (injected momentum/uniforms;
    interpret mode on CPU), on a Gaussian and on the funnel."""
    from mcmc_tpu.targets import get_target
    from mcmc_tpu.ops.fused_trajectory import make_debug_trajectory
    from mcmc_tpu.samplers import get_friction_schedule
    from mcmc_tpu.samplers.trajectory import (integrate_trajectory,
                                              kinetic_energy)

    dim, n_chains, L = 6, 8, 5
    t = get_target(family, dim=dim)
    k1, k2, k3 = random.split(random.PRNGKey(0), 3)
    q = (random.normal(k1, (n_chains, dim)) * 0.5).astype(jnp.float32)
    rng = np.random.default_rng(0)
    a = rng.normal(size=(dim, dim)).astype(np.float32)
    invm = jnp.asarray(a @ a.T / dim + 0.5 * np.eye(dim), jnp.float32)
    p0 = random.normal(k2, (n_chains, dim), dtype=jnp.float32)
    u = random.uniform(k3, (n_chains,), dtype=jnp.float32)
    lp, grad = t.value_and_grad_fn(q)
    lp = lp.astype(jnp.float32)
    eps, gamma, steep = 0.1, 1.0, 0.5
    sched = get_friction_schedule("tanh")

    with jax.default_matmul_precision("highest"):
        qx, px, lpx, _ = integrate_trajectory(
            q, p0, lp, grad.astype(jnp.float32), t.value_and_grad_fn, eps,
            L, invm, friction_schedule=sched, gamma_max=gamma,
            steepness=steep)
        h0 = -lp + kinetic_energy(p0, invm)
        h1 = -lpx + kinetic_energy(-px, invm)
    acc_ref = jnp.log(u) < jnp.minimum(0.0, h0 - h1)
    q_ref = jnp.where(acc_ref[:, None], qx, q)

    run = make_debug_trajectory(t.value_and_grad_fn, L, sched,
                                backend="interpret")
    qk, _, _, acck, dhk = run(q, lp, grad, p0, u, eps, gamma, steep, invm)
    np.testing.assert_array_equal(np.asarray(acck), np.asarray(acc_ref))
    np.testing.assert_allclose(np.asarray(qk), np.asarray(q_ref),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(dhk), np.asarray(h1 - h0),
                               rtol=2e-3, atol=2e-3)


def test_fused_grahmc_run_dense_multistep_moments():
    """grahmc_run(backend='interpret') with an ORACLE dense metric runs
    the fused kernel (dense metric factored once per run) and recovers the
    rho=0.9 covariance."""
    from mcmc_tpu.samplers import grahmc_run
    from mcmc_tpu.samplers.grahmc import NO_FRICTION

    dim = 4
    t = correlated_gaussian(dim, correlation=0.9)
    init = random.normal(random.PRNGKey(5), (64, dim)) * 0.3
    res = grahmc_run(random.PRNGKey(6), t.log_prob_fn, init, 0.5, 8, 0.0,
                     1.0, num_samples=500, burn_in=100,
                     inv_mass_matrix=jnp.asarray(t.true_cov, jnp.float32),
                     friction_schedule=NO_FRICTION,
                     value_and_grad_fn=t.value_and_grad_fn,
                     backend="interpret")
    assert float(np.mean(res.accept_rate)) > 0.8   # oracle metric, eps 0.5
    s = np.asarray(res.samples).reshape(-1, dim)
    np.testing.assert_allclose(np.cov(s.T), np.asarray(t.true_cov),
                               atol=0.15)


def test_fused_grahmc_run_dense_single_step_moments():
    """Same with track_proposals=True — covers the proposal-endpoint
    export of the fused kernel under a dense metric."""
    from mcmc_tpu.samplers import grahmc_run
    from mcmc_tpu.samplers.grahmc import NO_FRICTION

    dim = 4
    t = correlated_gaussian(dim, correlation=0.9)
    init = random.normal(random.PRNGKey(7), (64, dim)) * 0.3
    res = grahmc_run(random.PRNGKey(8), t.log_prob_fn, init, 0.5, 8, 0.0,
                     1.0, num_samples=500, burn_in=100,
                     inv_mass_matrix=jnp.asarray(t.true_cov, jnp.float32),
                     friction_schedule=NO_FRICTION, track_proposals=True,
                     value_and_grad_fn=t.value_and_grad_fn,
                     backend="interpret")
    s = np.asarray(res.samples).reshape(-1, dim)
    np.testing.assert_allclose(np.cov(s.T), np.asarray(t.true_cov),
                               atol=0.15)
    assert "proposal_positions" in res.info  # ESJD plumbing alive


def test_prepared_dense_metric_matches_raw():
    """PreparedDenseMetric (factored once, outside the sampling loop) is
    bit-identical to passing the raw (D, D) matrix: same key -> same
    injected randomness -> same transition. The prepared form exists so
    ChEES's per-draw lax.switch branches don't re-run the Cholesky +
    triangular solve every draw (XLA LICM can't hoist out of nested
    branch computations)."""
    from mcmc_tpu.ops.fused_trajectory import (
        make_fused_grahmc_step, prepare_dense_metric)
    from mcmc_tpu.samplers.base import init_chain_state

    dim = 4
    t = correlated_gaussian(dim, correlation=0.9)
    init = random.normal(random.PRNGKey(11), (16, dim)).astype(jnp.float32)
    cs = init_chain_state(init, t.log_prob_fn, t.value_and_grad_fn,
                          needs_grad=True)
    fused = make_fused_grahmc_step(t.log_prob_fn, t.value_and_grad_fn, 6,
                                   None, backend="interpret")
    raw = jnp.asarray(t.true_cov, jnp.float32)
    prepared = prepare_dense_metric(raw, dim)
    args = (random.PRNGKey(12), cs, jnp.float32(0.4), jnp.float32(0.0),
            jnp.float32(1.0))
    _, s_raw, (acc_raw, *_) = fused(*args, raw)
    _, s_prep, (acc_prep, *_) = fused(*args, prepared)
    np.testing.assert_array_equal(np.asarray(s_raw.position),
                                  np.asarray(s_prep.position))
    np.testing.assert_array_equal(np.asarray(acc_raw), np.asarray(acc_prep))

    # a metric prepared for another dim (wrong d_pad) is rejected
    wrong = prepare_dense_metric(jnp.eye(20, dtype=jnp.float32), 20)
    with pytest.raises(ValueError, match="d_pad"):
        fused(*args, wrong)


def test_nuts_dense_runs_and_samples():
    """Classic NUTS with a dense metric: exact moments on the correlated
    Gaussian (the U-turn test stays the reference's q-space criterion)."""
    from mcmc_tpu.samplers import nuts_run

    dim = 4
    t = correlated_gaussian(dim, correlation=0.9)
    init = random.normal(random.PRNGKey(5), (32, dim)) * 0.3
    res = nuts_run(random.PRNGKey(6), t.log_prob_fn, init, step_size=0.5,
                   num_samples=500, burn_in=100,
                   inv_mass_matrix=jnp.asarray(t.true_cov),
                   max_tree_depth=8, value_and_grad_fn=t.value_and_grad_fn)
    s = np.asarray(res.samples).reshape(-1, dim)
    np.testing.assert_allclose(np.cov(s.T), np.asarray(t.true_cov),
                               atol=0.15)


def test_persistent_nuts_dense_runs_and_samples():
    """Persistent NUTS with the ORACLE dense metric: the XLA state machine
    is metric-polymorphic (velocity drift, dense kinetic, Cholesky
    momentum unwhitening, raw-momentum U-turn — invariant under
    whitening) — exact moments on the rho=0.9 correlated Gaussian."""
    from mcmc_tpu.samplers import nuts_run_persistent

    dim = 4
    t = correlated_gaussian(dim, correlation=0.9)
    init = random.normal(random.PRNGKey(5), (64, dim)) * 0.3
    res = nuts_run_persistent(
        random.PRNGKey(6), t.log_prob_fn, init, step_size=0.5,
        num_samples=400, steps_per_sample=8, burn_in_steps=64,
        inv_mass_matrix=jnp.asarray(t.true_cov), max_tree_depth=8,
        value_and_grad_fn=t.value_and_grad_fn)
    s = np.asarray(res.samples).reshape(-1, dim)
    np.testing.assert_allclose(np.cov(s.T), np.asarray(t.true_cov),
                               atol=0.15)
    assert abs(s.mean()) < 0.05
    # the whitened dynamics should accept generously at step 0.5
    assert float(res.accept_rate.mean()) > 0.6


def test_persistent_nuts_dense_pallas_backend_moments():
    """Persistent NUTS (the XLA machine) with an ORACLE dense metric under
    the multinomial scheme, from float32 inputs — exact moments on the
    rho=0.9 correlated Gaussian."""
    from mcmc_tpu.samplers import nuts_run_persistent

    dim = 4
    t = correlated_gaussian(dim, correlation=0.9)
    init = (random.normal(random.PRNGKey(5), (64, dim)) * 0.3).astype(
        jnp.float32)
    res = nuts_run_persistent(
        random.PRNGKey(6), t.log_prob_fn, init, step_size=0.5,
        num_samples=400, steps_per_sample=8, burn_in_steps=64,
        inv_mass_matrix=jnp.asarray(t.true_cov, jnp.float32),
        max_tree_depth=8, proposal_scheme="multinomial",
        value_and_grad_fn=t.value_and_grad_fn)
    s = np.asarray(res.samples).reshape(-1, dim)
    np.testing.assert_allclose(np.cov(s.T), np.asarray(t.true_cov),
                               atol=0.15)
    assert abs(s.mean()) < 0.05
    assert float(res.accept_rate.mean()) > 0.6   # whitened dynamics


@pytest.mark.slow
def test_warmup_learns_dense_metric():
    """run_adaptive_warmup(learn_mass_matrix='dense') on the rho=0.9
    Gaussian must learn a (D, D) metric whose correlation structure matches
    the target (off-diagonals ~ 0.9 after shrinkage)."""
    from mcmc_tpu.tuning import run_adaptive_warmup

    dim = 4
    t = correlated_gaussian(dim, correlation=0.9)
    init = random.normal(random.PRNGKey(7), (64, dim)) * 0.3
    step, inv_mass, pos, info = run_adaptive_warmup(
        "hmc", t.log_prob_fn, None, init, random.PRNGKey(8),
        num_warmup=1200, num_steps=8, learn_mass_matrix="dense",
        value_and_grad_fn=t.value_and_grad_fn,
        exploration_steps=300, adaptation_windows=[100, 200, 400],
        cooldown_steps=200)
    assert inv_mass.shape == (dim, dim)
    corr = np.asarray(inv_mass)
    corr = corr / np.sqrt(np.outer(np.diag(corr), np.diag(corr)))
    off = corr[~np.eye(dim, dtype=bool)]
    assert off.min() > 0.5, corr          # learned the rho=0.9 ridge
    assert info["mass_matrix_learned"] == "dense"
    assert step > 0 and np.isfinite(np.asarray(pos)).all()


def test_warmup_dense_pallas_backend():
    """run_adaptive_warmup with learn_mass_matrix='dense' and the kernel
    backend (under the interpreter) runs its window scans through the
    fused kernel (no xla downgrade) and still learns a (D, D) metric
    aligned with the target covariance."""
    from mcmc_tpu.tuning import run_adaptive_warmup

    dim = 4
    t = correlated_gaussian(dim, correlation=0.9)
    init = random.normal(random.PRNGKey(0), (32, dim)) * 0.3
    step, inv_mass, pos, info = run_adaptive_warmup(
        "grahmc", t.log_prob_fn, None, init, random.PRNGKey(1),
        num_warmup=400, learn_mass_matrix="dense", backend="interpret",
        value_and_grad_fn=t.value_and_grad_fn, schedule_type="constant")
    assert inv_mass.shape == (dim, dim)
    assert np.isfinite(step) and step > 0
    # learned off-diagonal correlation has the right sign structure
    corr = np.asarray(inv_mass)
    assert corr[0, 1] > 0
    assert np.all(np.isfinite(np.asarray(pos)))


def test_chees_run_pallas_dense_interpret():
    """chees_run accepts a dense metric on the kernel backend: the
    quantized fused kernels take the (D, D) M^{-1} as an operand
    (interpret mode on CPU, same kernel body as on the GPU)."""
    from mcmc_tpu.tuning.chees import chees_run

    dim = 4
    t = correlated_gaussian(dim, correlation=0.9)
    init = random.normal(random.PRNGKey(2), (16, dim)).astype(jnp.float32)
    res = chees_run(random.PRNGKey(3), t.log_prob_fn, init, step_size=0.4,
                    trajectory_length=2.0, num_samples=48,
                    inv_mass_matrix=jnp.asarray(t.true_cov, jnp.float32),
                    value_and_grad_fn=t.value_and_grad_fn,
                    backend="interpret", jitter_levels=3)
    assert res.info["jitter_backend"] == "interpret"
    assert np.isfinite(np.asarray(res.samples)).all()
    assert 0.0 < float(res.accept_rate.mean()) <= 1.0


def test_warmup_dense_fused_windows():
    """Persistent-NUTS warmup windows with a dense metric work: the XLA
    machine is metric-polymorphic and the warmup learns a (D, D) metric."""
    from mcmc_tpu.tuning import run_adaptive_warmup

    t = standard_normal(3)
    init = random.normal(random.PRNGKey(9), (8, 3)) * 0.2
    step, inv_mass, pos, info = run_adaptive_warmup(
        "nuts", t.log_prob_fn, None, init, random.PRNGKey(0),
        num_warmup=150, learn_mass_matrix="dense", backend="persistent",
        value_and_grad_fn=t.value_and_grad_fn,
        exploration_steps=50, adaptation_windows=[25, 50],
        cooldown_steps=25)
    assert inv_mass.shape == (3, 3)
    assert info["mass_matrix_learned"] == "dense"
    assert step > 0 and np.isfinite(np.asarray(pos)).all()


@pytest.mark.slow
def test_chees_grahmc_dense_with_friction_tuning():
    """GRAHMC + ChEES + dense: the phase-3 sequential friction tuner
    accepts the (D, D) metric (the fused probe kernel takes it as an
    operand on a GPU; XLA probes on CPU); the learned metric still
    captures the ridge."""
    from mcmc_tpu.tuning.chees import run_chees_warmup

    dim = 4
    t = correlated_gaussian(dim, correlation=0.9)
    init = random.normal(random.PRNGKey(3), (64, dim)) * 0.3
    step, inv_mass, pos, info = run_chees_warmup(
        "grahmc", t.log_prob_fn, None, init, random.PRNGKey(4),
        num_warmup=600, learn_mass_matrix="dense", schedule_type="tanh",
        value_and_grad_fn=t.value_and_grad_fn)
    assert inv_mass.shape == (dim, dim)
    assert step > 0 and info["trajectory_length"] > 0
    assert info.get("gamma") is not None    # phase 3 ran
    corr = np.asarray(inv_mass)
    corr = corr / np.sqrt(np.outer(np.diag(corr), np.diag(corr)))
    assert corr[~np.eye(dim, dtype=bool)].min() > 0.4, corr


def test_warmup_dense_under_mesh():
    """Dense metric learning under an 8-device chain mesh: the pooled
    moment state stays REPLICATED (per-step psum'd increments), the learned
    (D, D) metric captures the rho=0.9 ridge, and it matches the
    single-device warmup statistically."""
    from mcmc_tpu.tuning import run_adaptive_warmup
    from mcmc_tpu.parallel import make_mesh, shard_chains

    dim = 4
    t = correlated_gaussian(dim, correlation=0.9)
    mesh = make_mesh()
    init = shard_chains(
        random.normal(random.PRNGKey(7), (64, dim)) * 0.3, mesh)
    kw = dict(num_warmup=600, num_steps=8, learn_mass_matrix="dense",
              value_and_grad_fn=t.value_and_grad_fn,
              exploration_steps=150, adaptation_windows=[100, 250],
              cooldown_steps=100)
    step, inv_mass, pos, info = run_adaptive_warmup(
        "hmc", t.log_prob_fn, None, init, random.PRNGKey(8),
        mesh=mesh, **kw)
    assert inv_mass.shape == (dim, dim)
    assert info["mass_matrix_learned"] == "dense"
    corr = np.asarray(inv_mass)
    corr = corr / np.sqrt(np.outer(np.diag(corr), np.diag(corr)))
    off = corr[~np.eye(dim, dtype=bool)]
    assert off.min() > 0.4, corr          # learned the rho=0.9 ridge
    assert step > 0 and pos.shape == (64, dim)
    assert np.all(np.isfinite(np.asarray(pos)))

    # single-device arm (different RNG streams -> statistical, not bitwise)
    init1 = random.normal(random.PRNGKey(7), (64, dim)) * 0.3
    _, inv_mass1, _, _ = run_adaptive_warmup(
        "hmc", t.log_prob_fn, None, init1, random.PRNGKey(8), **kw)
    np.testing.assert_allclose(np.asarray(inv_mass),
                               np.asarray(inv_mass1), atol=0.35)


def test_mesh_dense_sampling_routing(monkeypatch):
    """_sample with a mesh and a dense metric dispatches the fused
    shard_map path for EVERY sampler — the trajectory kernels AND the
    persistent-NUTS window kernel run the (D, D) metric in-kernel. Both
    produce finite draws."""
    import mcmc_tpu.benchmark.runner as runner_mod
    from mcmc_tpu.parallel import make_mesh, shard_chains
    import mcmc_tpu.parallel.fused_sharded as fs

    seen = []
    real_grahmc_sharded = fs.grahmc_run_sharded
    real_nuts_sharded = fs.nuts_persistent_run_sharded

    def spy_grahmc(*a, **k):
        seen.append("grahmc_sharded")
        return real_grahmc_sharded(*a, **k)

    def spy_nuts(*a, **k):
        seen.append("nuts_sharded")
        return real_nuts_sharded(*a, **k)

    monkeypatch.setattr("mcmc_tpu.parallel.fused_sharded.grahmc_run_sharded",
                        spy_grahmc)
    monkeypatch.setattr(
        "mcmc_tpu.parallel.fused_sharded.nuts_persistent_run_sharded",
        spy_nuts)

    dim = 4
    t = correlated_gaussian(dim, correlation=0.9)
    mesh = make_mesh()
    pos = shard_chains(random.normal(random.PRNGKey(1), (32, dim)) * 0.3,
                       mesh)
    dense = jnp.asarray(t.true_cov)
    for sampler, nuts_backend in [("hmc", "classic"),
                                  ("nuts", "persistent")]:
        res = runner_mod._sample(
            sampler, t, random.PRNGKey(2), pos, step_size=0.5, num_steps=4,
            num_samples=8, inv_mass=dense, schedule_type="constant",
            warmup_info={}, backend="interpret", mesh=mesh,
            nuts_backend=nuts_backend, nuts_steps_per_sample=8)
        assert res.samples.shape[0] == 8
        assert np.all(np.isfinite(np.asarray(res.samples)))
    assert seen == ["grahmc_sharded", "nuts_sharded"]


def test_warmup_persistent_nuts_dense():
    """Persistent-NUTS warmup with a dense metric (default backend
    resolution — XLA machine on CPU) returns a (D, D) metric."""
    from mcmc_tpu.tuning import run_adaptive_warmup

    dim = 3
    t = standard_normal(dim)
    init = random.normal(random.PRNGKey(1), (16, dim)) * 0.2
    step, inv_mass, pos, info = run_adaptive_warmup(
        "nuts", t.log_prob_fn, None, init, random.PRNGKey(2),
        num_warmup=175, learn_mass_matrix="dense", backend="persistent",
        value_and_grad_fn=t.value_and_grad_fn,
        exploration_steps=50, adaptation_windows=[25, 50],
        cooldown_steps=50)
    assert inv_mass.shape == (dim, dim)
    assert info["mass_matrix_learned"] == "dense"
    assert step > 0 and np.isfinite(np.asarray(pos)).all()


@pytest.mark.slow
def test_cli_dense_mass_mode_e2e(tmp_path):
    """--mass-matrix-mode dense end-to-end: a full pipeline run on the
    correlated Gaussian with the learned dense metric, recorded in the
    result row (mass_matrix_learned == 'dense')."""
    from mcmc_tpu.benchmark import run_all_benchmarks

    # the dense metric whitens the target, so DA tunes a BIG step
    # (~1.45) and long trajectories orbit — give the grid short arms
    df = run_all_benchmarks(
        samplers=["hmc"], targets=["correlated_gaussian"],
        grahmc_schedules=["constant"], dim=4, n_chains=16,
        num_warmup=800, num_samples=600, seed=0,
        output_dir=str(tmp_path), num_steps_grid=[1, 2],
        mass_matrix_modes=["dense"], mesh_devices="off",
        warmup_cache=False)
    assert len(df) == 1
    row = df[0]
    assert row["mass_matrix_learned"] == "dense"
    assert row.get("error") is None or (isinstance(row.get("error"), float)
                                        and np.isnan(row.get("error")))
    assert row["ess_bulk_min"] > 100


def test_warmup_signature_distinguishes_dense():
    """Dense and diagonal warmups must never share a checkpoint key (a
    (D,) inv_mass restored into a dense run would silently sample the
    wrong metric — review finding)."""
    from mcmc_tpu.utils.checkpoint import warmup_signature

    kw = dict(sampler="hmc", target_name="T", schedule=None, num_steps=8,
              n_chains=16, dim=4, num_warmup=800)
    diag = warmup_signature(learn_mass=True, **kw)
    dense = warmup_signature(learn_mass="dense", **kw)
    off = warmup_signature(learn_mass=False, **kw)
    assert len({diag, dense, off}) == 3


def test_chees_dense_gradient_sign_structure():
    """The dense ChEES criterion gradient must change sign at the WHITENED
    quarter period T = pi/2: with the oracle metric (inv_mass = Sigma) the
    sphered dynamics are unit-frequency, so dC/dlogT > 0 below pi/2 and
    < 0 just above. This pins the Cholesky sphering math (z = L^{-1} q,
    dz/dt = L^T p) against an analytic fact."""
    from mcmc_tpu.tuning.chees import chees_log_t_grad
    from mcmc_tpu.samplers.base import make_value_and_grad
    from mcmc_tpu.samplers.trajectory import (
        integrate_trajectory_dynamic)

    t = correlated_gaussian(4, correlation=0.9)
    sigma = jnp.asarray(t.true_cov)
    vag = make_value_and_grad(t.log_prob_fn, t.value_and_grad_fn)
    key = random.PRNGKey(0)
    L = jnp.linalg.cholesky(sigma)
    q0 = random.normal(key, (4096, 4)) @ L.T      # exact target draws
    lp0, g0 = vag(q0)
    eps = 0.05
    grads = {}
    for T in (1.2, 2.2):
        k = random.fold_in(key, int(T * 100))
        p0 = sample_momentum(k, q0.shape, sigma, q0.dtype)
        q1, p1, lp1, _ = integrate_trajectory_dynamic(
            q0, p0, lp0, g0, vag, eps, int(round(T / eps)), sigma)
        h0 = -lp0 + kinetic_energy(p0, sigma)
        h1 = -lp1 + kinetic_energy(p1, sigma)
        alpha = jnp.exp(jnp.minimum(0.0, h0 - h1))
        grads[T] = float(chees_log_t_grad(q0, q1, p1, jnp.ones(()), T,
                                          alpha, sigma))
    assert grads[1.2] > 0.5, grads     # below pi/2: lengthen
    assert grads[2.2] < -0.5, grads    # above pi/2: shorten


def test_chees_warmup_learns_dense():
    """run_chees_warmup with learn_mass_matrix='dense': pooled moments
    learn the (D, D) ridge, the ChEES criterion spheres with the Cholesky,
    and the tuned trajectory decorrelates the rho=0.9 target."""
    from mcmc_tpu.tuning.chees import run_chees_warmup

    dim = 4
    t = correlated_gaussian(dim, correlation=0.9)
    init = random.normal(random.PRNGKey(3), (64, dim)) * 0.3
    step, inv_mass, pos, info = run_chees_warmup(
        "hmc", t.log_prob_fn, None, init, random.PRNGKey(4),
        num_warmup=600, learn_mass_matrix="dense",
        value_and_grad_fn=t.value_and_grad_fn,
        exploration_steps=150, adaptation_windows=[100, 250],
        cooldown_steps=100)
    assert inv_mass.shape == (dim, dim)
    assert info["mass_matrix_learned"] == "dense"
    corr = np.asarray(inv_mass)
    corr = corr / np.sqrt(np.outer(np.diag(corr), np.diag(corr)))
    off = corr[~np.eye(dim, dtype=bool)]
    assert off.min() > 0.4, corr
    assert step > 0 and info["trajectory_length"] > 0
    assert np.all(np.isfinite(np.asarray(pos)))


def test_dense_warmup_compiles_two_batch_programs(caplog):
    """The fixed-shape compile discipline must hold for dense warmups too:
    the carry starts as (DenseMomentState, eye(D)) so shapes stay uniform
    — two run_batch programs, not four (review finding)."""
    import logging
    from mcmc_tpu.tuning import run_adaptive_warmup

    t = standard_normal(4)
    init = random.normal(random.PRNGKey(3), (8, 4)) * 0.1
    jax.config.update("jax_log_compiles", True)
    try:
        with caplog.at_level(logging.WARNING,
                             logger="jax._src.interpreters.pxla"):
            run_adaptive_warmup(
                "hmc", t.log_prob_fn, None, init, random.PRNGKey(0),
                num_warmup=425, num_steps=4, learn_mass_matrix="dense",
                value_and_grad_fn=t.value_and_grad_fn,
                exploration_steps=100, adaptation_windows=[25, 50, 125],
                cooldown_steps=125)
    finally:
        jax.config.update("jax_log_compiles", False)
    compiles = [r.message for r in caplog.records
                if "Compiling jit(run_batch)" in r.message]
    assert 1 <= len(compiles) <= 2, compiles


@pytest.mark.slow
def test_cli_dense_mesh_e2e(tmp_path):
    """--mass-matrix-mode dense with an 8-device mesh: full pipeline,
    dense metric learned under the mesh, GSPMD sampling, gates evaluated.

    NUTS rather than HMC: at tiny fixed L the exactly-whitened Gaussian
    gives dual averaging a step-function acceptance cliff (no smooth 0.65
    point — both mesh and single-device arms overshoot ~50% of seeds);
    NUTS's adaptive tree depth keeps the DA response smooth."""
    from mcmc_tpu.benchmark import run_all_benchmarks

    df = run_all_benchmarks(
        samplers=["nuts"], targets=["correlated_gaussian"],
        grahmc_schedules=["constant"], dim=4, n_chains=32,
        num_warmup=600, num_samples=400, seed=0,
        output_dir=str(tmp_path), num_steps_grid=[2],
        mass_matrix_modes=["dense"], mesh_devices=8,
        warmup_cache=False)
    assert len(df) == 1
    row = df[0]
    assert row["mass_matrix_learned"] == "dense"
    assert row["ess_bulk_min"] > 100
    assert row["rhat_max"] < 1.1
