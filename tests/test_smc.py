"""Annealed SMC (samplers/smc.py): normalizing-constant estimation,
systematic resampling, adaptive temperature schedule, mixture transport.

The log-Z checks are the strongest end-to-end correctness tests in the
suite: every framework target is a NORMALIZED density, so the SMC evidence
estimate must come back log Z == 0 to Monte-Carlo error — any bug in the
reweighting, resampling, or move-kernel invariance shows up as a bias."""

import numpy as np
import pytest

import jax.numpy as jnp
from jax import random

from mcmc_tpu.samplers import (gaussian_base, smc_run, systematic_resample,
                               weighted_moments)
from mcmc_tpu.samplers.grahmc import tanh_schedule
from mcmc_tpu.targets import get_target


def test_systematic_resample_copy_counts():
    """Particle i appears floor(P*w_i) or ceil(P*w_i) times — the defining
    property of systematic resampling (minimum-variance unbiased counts)."""
    w = jnp.asarray([0.5, 0.25, 0.125, 0.125])
    lw = jnp.log(w)
    for seed in range(5):
        idx = np.asarray(systematic_resample(random.PRNGKey(seed), lw))
        counts = np.bincount(idx, minlength=4)
        expected = np.asarray(w) * 4
        assert np.all(counts >= np.floor(expected))
        assert np.all(counts <= np.ceil(expected))
        assert counts.sum() == 4


def test_systematic_resample_degenerate_weight():
    """All mass on one particle -> every index is that particle."""
    lw = jnp.asarray([-1e30, 0.0, -1e30, -1e30])
    idx = np.asarray(systematic_resample(random.PRNGKey(0), lw))
    assert np.all(idx == 1)


def test_gaussian_base_normalized():
    """The base must be a NORMALIZED density (the Z estimator divides by
    its integral): Monte-Carlo check of E_p0[1] via its own samples, and
    the analytic grad matches finite differences."""
    sampler, lp, vag = gaussian_base(3, mean=1.5, scale=2.0)
    x = sampler(random.PRNGKey(0), 8).astype(jnp.float64)
    v, g = vag(x)
    np.testing.assert_allclose(np.asarray(v), np.asarray(lp(x)), rtol=1e-6)
    eps = 1e-4
    for d in range(3):
        xp = x.at[:, d].add(eps)
        xm = x.at[:, d].add(-eps)
        fd = (lp(xp) - lp(xm)) / (2 * eps)
        np.testing.assert_allclose(np.asarray(g[:, d]), np.asarray(fd),
                                   rtol=1e-3, atol=1e-3)
    # exact normalization on a grid (1-D case)
    _, lp1, _ = gaussian_base(1, mean=0.0, scale=2.0)
    xs = jnp.linspace(-20, 20, 4001)[:, None]
    integral = jnp.trapezoid(jnp.exp(lp1(xs)), xs[:, 0])
    assert abs(float(integral) - 1.0) < 1e-6


def test_smc_logz_normalized_target():
    """Adaptive-schedule SMC on the (normalized) standard normal from a
    WIDE base (scale 3 -> a real multi-stage bridge): log Z == 0 to MC
    error, and the weighted posterior moments are the target's."""
    t = get_target("standard_normal", dim=5)
    r = smc_run(random.PRNGKey(0), t.log_prob_fn, n_particles=2048, dim=5,
                step_size=0.5, num_steps=8, base_scale=3.0,
                value_and_grad_fn=t.value_and_grad_fn)
    assert int(r.info["n_stages"]) >= 2          # nontrivial bridge
    # 10-seed sweep at this config: mean(log_Z) = -0.003, std = 0.026 (no
    # bias; Jensen makes E[log Z] <= 0) -> 0.12 is a ~4.5-sigma gate
    assert abs(float(r.log_Z)) < 0.12
    mean, cov = weighted_moments(r.particles, r.log_weights)
    assert float(jnp.abs(mean).max()) < 0.15
    np.testing.assert_allclose(np.asarray(jnp.diag(cov)), 1.0, atol=0.15)
    # normalized-weight invariant
    assert abs(float(jnp.exp(r.log_weights).sum()) - 1.0) < 1e-6


def test_smc_logz_known_constant():
    """An unnormalized target logp + c must report log Z == c: the additive
    constant passes through the incremental weights untouched by moves."""
    t = get_target("standard_normal", dim=4)
    lp = lambda x: t.log_prob_fn(x) + 3.7
    vag = lambda x: (t.value_and_grad_fn(x)[0] + 3.7,
                     t.value_and_grad_fn(x)[1])
    r = smc_run(random.PRNGKey(1), lp, n_particles=2048, dim=4,
                step_size=0.5, num_steps=8, base_scale=2.0,
                value_and_grad_fn=vag)
    assert abs(float(r.log_Z) - 3.7) < 0.05


def test_smc_logz_unnormalized_gaussian():
    """Fully analytic evidence: logp = -|x|^2/(2 s^2) has
    Z = (2 pi s^2)^{D/2}. Exercises a base (scale 1) NARROWER than the
    target (scale 2) — annealing outward."""
    D, s = 4, 2.0
    lp = lambda x: -0.5 * jnp.sum(x * x, axis=-1) / s**2
    vag = lambda x: (lp(x), -x / s**2)
    true_logz = 0.5 * D * np.log(2 * np.pi * s**2)
    r = smc_run(random.PRNGKey(2), lp, n_particles=2048, dim=D,
                step_size=0.4, num_steps=8, value_and_grad_fn=vag)
    assert abs(float(r.log_Z) - true_logz) < 0.08


def test_smc_fixed_schedule_matches_adaptive():
    """A fixed ascending schedule estimates the same constant, runs exactly
    len(betas) stages, and records them verbatim."""
    t = get_target("standard_normal", dim=3)
    betas = jnp.linspace(0.2, 1.0, 5)
    r = smc_run(random.PRNGKey(3), t.log_prob_fn, n_particles=1024, dim=3,
                step_size=0.5, num_steps=8, betas=betas, base_scale=2.0,
                value_and_grad_fn=t.value_and_grad_fn)
    assert int(r.info["n_stages"]) == 5
    np.testing.assert_allclose(np.asarray(r.info["betas"][:5]),
                               np.asarray(betas), rtol=1e-6)
    assert abs(float(r.log_Z)) < 0.1


def test_smc_schedule_validation():
    """Bad explicit schedules error loudly: betas[-1] != 1 estimates the
    wrong constant, non-ascending steps break the incremental weights."""
    t = get_target("standard_normal", dim=2)
    kw = dict(n_particles=64, dim=2, step_size=0.5, num_steps=4,
              value_and_grad_fn=t.value_and_grad_fn)
    with pytest.raises(ValueError, match=r"betas\[-1\] must be 1"):
        smc_run(random.PRNGKey(0), t.log_prob_fn,
                betas=jnp.asarray([0.3, 0.9]), **kw)
    with pytest.raises(ValueError, match="ascending"):
        smc_run(random.PRNGKey(0), t.log_prob_fn,
                betas=jnp.asarray([0.5, 0.4, 1.0]), **kw)
    with pytest.raises(ValueError, match="1-D"):
        smc_run(random.PRNGKey(0), t.log_prob_fn, betas=jnp.ones((2, 2)),
                **kw)
    with pytest.raises(ValueError, match="target_rel_ess"):
        smc_run(random.PRNGKey(0), t.log_prob_fn, target_rel_ess=1.5, **kw)
    with pytest.raises(ValueError, match="base_scale"):
        smc_run(random.PRNGKey(0), t.log_prob_fn, base_scale=-1.0, **kw)


def test_smc_mixture_transport_and_evidence():
    """The flagship use: a bimodal mixture (the reference's benchmark
    workaround target) — SMC finds BOTH modes from a generic wide base,
    splits mass evenly, recovers the exact bimodal variance, and the
    evidence of the normalized mixture reads 0."""
    mt = get_target("gaussian_mixture", dim=10)   # sep=5: var_x0 = 7.25
    r = smc_run(random.PRNGKey(4), mt.log_prob_fn, n_particles=4096, dim=10,
                step_size=0.4, num_steps=16, base_scale=6.0,
                value_and_grad_fn=mt.value_and_grad_fn, final_resample=True)
    assert abs(float(r.log_Z)) < 0.15
    x0 = np.asarray(r.particles[:, 0])
    frac_pos = float((x0 > 0).mean())
    assert 0.35 < frac_pos < 0.65                 # both modes, even mass
    assert abs(x0.var() - 7.25) < 0.8
    # final_resample returns a uniform-weight population
    np.testing.assert_allclose(np.asarray(r.log_weights),
                               -np.log(4096), rtol=1e-6)


def test_smc_grahmc_moves():
    """Friction-schedule (GRAHMC) move kernels keep the estimator exact —
    the move phase only needs pi_b-invariance, not a specific kernel."""
    t = get_target("standard_normal", dim=3)
    r = smc_run(random.PRNGKey(5), t.log_prob_fn, n_particles=1024, dim=3,
                step_size=0.5, num_steps=8, base_scale=2.5,
                gamma=0.5, steepness=5.0, friction_schedule=tanh_schedule,
                value_and_grad_fn=t.value_and_grad_fn)
    # MC noise at 1024 particles is ~0.04 (see the 10-seed sweep note in
    # test_smc_logz_normalized_target); ~4-sigma gate
    assert abs(float(r.log_Z)) < 0.15


def test_smc_info_schema_and_step_adaptation():
    """Info contract: ascending realized betas ending at 1, resample count
    == flagged stages, per-stage acceptance in (0,1], and the Robbins-Monro
    step tuner moves eps toward the 0.65-acceptance region."""
    t = get_target("ill_conditioned_gaussian", dim=6)
    r = smc_run(random.PRNGKey(6), t.log_prob_fn, n_particles=1024, dim=6,
                step_size=1.5, num_steps=8, base_scale=3.0,
                value_and_grad_fn=t.value_and_grad_fn)
    n = int(r.info["n_stages"])
    betas = np.asarray(r.info["betas"][:n])
    assert np.all(np.diff(np.concatenate([[0.0], betas])) > 0)
    assert abs(betas[-1] - 1.0) < 1e-6
    assert int(r.info["n_resamples"]) == int(
        np.asarray(r.info["resampled"][:n]).sum())
    acc = np.asarray(r.info["accept"][:n])
    assert np.all((acc >= 0.0) & (acc <= 1.0))
    # the within-stage tuner must keep every stage's moves alive — before
    # it, the bridge's moving stability cliff zeroed whole stages (measured
    # acceptance 0.002 with between-stage-only adaptation)
    assert np.all(acc > 0.2)
    assert np.asarray(r.info["step_size"][0]) == np.float32(1.5)
    assert abs(float(r.log_Z)) < 0.35             # ill-conditioned: wider MC


def test_smc_sharded_on_mesh():
    """smc_run_sharded on the 8-device CPU mesh: the global-reduction
    design means every device takes the same adaptive-schedule branches,
    the weights stay GLOBALLY normalized through island-local resampling,
    and the evidence of a normalized target still reads 0."""
    from mcmc_tpu.parallel import CHAIN_AXIS, make_mesh
    from mcmc_tpu.parallel.fused_sharded import smc_run_sharded

    mesh = make_mesh(8)
    t = get_target("standard_normal", dim=4)
    r = smc_run_sharded(random.PRNGKey(7), t.log_prob_fn, mesh,
                        n_particles=2048, dim=4, step_size=0.5, num_steps=8,
                        base_scale=3.0,
                        value_and_grad_fn=t.value_and_grad_fn)
    assert r.particles.shape == (2048, 4)
    assert CHAIN_AXIS in str(r.particles.sharding.spec)
    # global normalization invariant survives island-local resampling
    assert abs(float(jnp.exp(r.log_weights).sum()) - 1.0) < 1e-5
    assert int(r.info["n_stages"]) >= 2
    assert abs(float(r.log_Z)) < 0.1
    mean, cov = weighted_moments(r.particles, r.log_weights)
    assert float(jnp.abs(mean).max()) < 0.2
    np.testing.assert_allclose(np.asarray(jnp.diag(cov)), 1.0, atol=0.2)
    betas = np.asarray(r.info["betas"][:int(r.info["n_stages"])])
    assert np.all(np.diff(np.concatenate([[0.0], betas])) > 0)
    assert abs(betas[-1] - 1.0) < 1e-6


def test_smc_sharded_validation():
    from mcmc_tpu.parallel import make_mesh
    from mcmc_tpu.parallel.fused_sharded import smc_run_sharded
    mesh = make_mesh(8)
    t = get_target("standard_normal", dim=2)
    with pytest.raises(ValueError, match="divisible"):
        smc_run_sharded(random.PRNGKey(0), t.log_prob_fn, mesh,
                        n_particles=1001, dim=2, step_size=0.5, num_steps=4)
    with pytest.raises(ValueError, match="per device"):
        smc_run_sharded(random.PRNGKey(0), t.log_prob_fn, mesh,
                        n_particles=8, dim=2, step_size=0.5, num_steps=4)


def test_weighted_moments_exact():
    """Closed-form check of the self-normalized estimates."""
    x = jnp.asarray([[0.0, 0.0], [2.0, 4.0]])
    lw = jnp.log(jnp.asarray([0.25, 0.75]))
    mean, cov = weighted_moments(x, lw)
    np.testing.assert_allclose(np.asarray(mean), [1.5, 3.0], rtol=1e-6)
    # cov = sum w (x-m)(x-m)^T = .25*[1.5,3]^2-outer + .75*[.5,1]^2-outer
    exp = 0.25 * np.outer([-1.5, -3], [-1.5, -3]) \
        + 0.75 * np.outer([0.5, 1], [0.5, 1])
    np.testing.assert_allclose(np.asarray(cov), exp, rtol=1e-6)


def test_smc_chees_trajectory_tuning():
    """tune_trajectory=True: ChEES Adam-on-log-T inside the annealing loop
    (Devlin et al. 2025 composition). On a sigma=2 Gaussian bridge the
    optimal trajectory length is pi/2 * sigma ~ 3.1; starting from
    T0 = num_steps*eps = 0.6 the tuner must climb decisively toward it
    while the evidence stays exact, and the realized leapfrog count must
    be reported per particle."""
    dim = 4

    def lp(x):  # N(0, 4 I), normalized -> log Z = 0
        return (-0.125 * jnp.sum(x * x, axis=-1)
                - 0.5 * dim * jnp.log(2 * jnp.pi * 4.0))

    betas = np.linspace(0.05, 1.0, 25)       # long ladder = many updates
    r = smc_run(random.PRNGKey(1), lp, n_particles=2048, dim=dim,
                step_size=0.3, num_steps=2, move_steps=4, betas=betas,
                tune_trajectory=True, max_leapfrogs=32, base_scale=2.0)
    n_stages = int(r.info["n_stages"])
    assert n_stages == 25
    traj = np.asarray(r.info["trajectory_length"][:n_stages])
    assert traj[0] == pytest.approx(0.6, rel=1e-5)     # T0 = 2 * 0.3
    final_t = float(r.info["final_trajectory_length"])
    assert final_t > 1.5, f"tuner failed to climb: {traj}"
    assert abs(float(r.log_Z)) < 0.15
    n_lf = int(r.info["n_leapfrogs"])
    assert n_lf > 0
    # realized counts are jittered: strictly fewer than the cap says
    assert n_lf < 25 * 4 * 32
    # determinism: same key -> bit-identical run
    r2 = smc_run(random.PRNGKey(1), lp, n_particles=2048, dim=dim,
                 step_size=0.3, num_steps=2, move_steps=4, betas=betas,
                 tune_trajectory=True, max_leapfrogs=32, base_scale=2.0)
    assert float(r2.log_Z) == float(r.log_Z)
    assert int(r2.info["n_leapfrogs"]) == n_lf


def test_smc_chees_default_path_rng_unchanged():
    """Adding the tuner must not perturb the default path's RNG stream:
    tune_trajectory=False reproduces the pre-tuner results bit-for-bit
    (the jitter key is only split off in tuning mode)."""
    t = get_target("standard_normal", dim=3)
    kw = dict(n_particles=512, dim=3, step_size=0.5, num_steps=4,
              move_steps=2)
    r1 = smc_run(random.PRNGKey(7), t.log_prob_fn, **kw)
    r2 = smc_run(random.PRNGKey(7), t.log_prob_fn, **kw,
                 tune_trajectory=False)
    assert float(r1.log_Z) == float(r2.log_Z)
    # fixed path charges stages * moves * num_steps per particle
    assert (int(r1.info["n_leapfrogs"])
            == int(r1.info["n_stages"]) * 2 * 4)


def test_smc_chees_sharded_on_mesh():
    """Tuned SMC under an 8-device mesh: the jitter stream is replicated
    (unfolded key), the criterion gradient is psum'd, so the log-T
    trajectory is identical on every device and the run completes with a
    normalized population and finite evidence."""
    from mcmc_tpu.parallel import make_mesh
    from mcmc_tpu.parallel.fused_sharded import smc_run_sharded
    mesh = make_mesh(8)
    t = get_target("standard_normal", dim=3)
    r = smc_run_sharded(random.PRNGKey(2), t.log_prob_fn, mesh,
                        n_particles=2048, dim=3, step_size=0.4,
                        num_steps=3, move_steps=3, tune_trajectory=True,
                        value_and_grad_fn=t.value_and_grad_fn)
    assert np.isfinite(float(r.log_Z)) and abs(float(r.log_Z)) < 0.3
    # global weight normalization survives (island-local resampling)
    assert np.isclose(float(jnp.sum(jnp.exp(r.log_weights))), 1.0,
                      atol=1e-4)
    n_stages = int(r.info["n_stages"])
    traj = np.asarray(r.info["trajectory_length"][:n_stages])
    assert np.all(np.isfinite(traj)) and np.all(traj > 0)
    assert int(r.info["n_leapfrogs"]) > 0


def test_resolve_move_backend():
    """Backend resolution contract: auto picks the kernel only on a GPU,
    explicit kernel backends validate their preconditions loudly."""
    import jax
    from mcmc_tpu.samplers.smc import resolve_move_backend
    t = get_target("standard_normal", dim=3)
    got = resolve_move_backend("auto", t.value_and_grad_fn, False, None)
    expect = "pallas" if jax.default_backend() == "gpu" else "xla"
    assert got == expect
    assert resolve_move_backend("interpret", t.value_and_grad_fn, False,
                                None) == "interpret"
    # dense metrics stay XLA under auto
    assert resolve_move_backend("auto", t.value_and_grad_fn, False,
                                jnp.eye(3)) == "xla"
    # tuned-trajectory path always stays XLA under auto
    assert resolve_move_backend(
        "auto", t.value_and_grad_fn, True, None) == "xla"
    with pytest.raises(ValueError):
        resolve_move_backend("pallas", t.value_and_grad_fn, True, None)
    with pytest.raises(TypeError):
        resolve_move_backend("pallas", lambda x: x, False, None)
    with pytest.raises(ValueError):
        resolve_move_backend("cuda", t.value_and_grad_fn, False, None)


def test_smc_pallas_moves_logz_and_moments():
    """Fused bridge-kernel moves (move_backend='interpret': the kernel under
    the interpreter) keep the estimator exact: log Z == 0 on a normalized target and
    the weighted moments match. This is the log-Z invariance gate for the
    round-4 SMC fusion (VERDICT r3 #1)."""
    t = get_target("standard_normal", dim=5)
    r = smc_run(random.PRNGKey(11), t.log_prob_fn, n_particles=1024, dim=5,
                step_size=0.5, num_steps=8, base_scale=3.0, move_steps=3,
                value_and_grad_fn=t.value_and_grad_fn,
                move_backend="interpret")
    assert abs(float(r.log_Z)) < 0.1
    mean, cov = weighted_moments(r.particles, r.log_weights)
    np.testing.assert_allclose(np.asarray(mean), np.zeros(5), atol=0.2)
    np.testing.assert_allclose(np.asarray(jnp.diag(cov)), np.ones(5),
                               atol=0.35)
    # fixed-path leapfrog accounting is backend-independent
    assert (int(r.info["n_leapfrogs"])
            == int(r.info["n_stages"]) * 3 * 8)


def test_smc_pallas_matches_xla_statistically():
    """Both move backends target the same bridge distributions; with a
    FIXED beta schedule the stage structure is identical and the two
    estimators must agree to Monte-Carlo error (streams intentionally
    differ — the pin is versioned, samplers/smc.py docstring)."""
    t = get_target("correlated_gaussian", dim=6)
    betas = np.linspace(0.1, 1.0, 10)
    kw = dict(n_particles=2048, dim=6, step_size=0.3, num_steps=6,
              move_steps=3, betas=betas, base_scale=2.0,
              value_and_grad_fn=t.value_and_grad_fn)
    rx = smc_run(random.PRNGKey(3), t.log_prob_fn, move_backend="xla", **kw)
    rp = smc_run(random.PRNGKey(3), t.log_prob_fn, move_backend="interpret",
                 **kw)
    assert abs(float(rx.log_Z)) < 0.25 and abs(float(rp.log_Z)) < 0.25
    mx, _ = weighted_moments(rx.particles, rx.log_weights)
    mp, _ = weighted_moments(rp.particles, rp.log_weights)
    np.testing.assert_allclose(np.asarray(mx), np.asarray(mp), atol=0.4)
    # same fixed schedule -> same stage count and per-stage accounting
    assert int(rx.info["n_stages"]) == int(rp.info["n_stages"])
    # acceptance in the same healthy band (the Robbins-Monro eps
    # trajectories see statistically equivalent move kernels)
    ax = float(np.asarray(rx.info["accept"])[:int(rx.info["n_stages"])].mean())
    ap = float(np.asarray(rp.info["accept"])[:int(rp.info["n_stages"])].mean())
    assert abs(ax - ap) < 0.2


def test_smc_pallas_sharded_on_mesh():
    """Fused bridge moves inside shard_map over an 8-device mesh: global
    weight reductions stay exact, the population stays normalized, and the
    evidence is unbiased — the mesh path dispatches the SAME kernel
    (VERDICT r3 #1 'done' criterion)."""
    from mcmc_tpu.parallel import make_mesh
    from mcmc_tpu.parallel.fused_sharded import smc_run_sharded
    mesh = make_mesh(8)
    t = get_target("standard_normal", dim=3)
    r = smc_run_sharded(random.PRNGKey(4), t.log_prob_fn, mesh,
                        n_particles=2048, dim=3, step_size=0.4,
                        num_steps=4, move_steps=2, base_scale=2.5,
                        value_and_grad_fn=t.value_and_grad_fn,
                        move_backend="interpret")
    assert np.isfinite(float(r.log_Z)) and abs(float(r.log_Z)) < 0.25
    assert np.isclose(float(jnp.sum(jnp.exp(r.log_weights))), 1.0,
                      atol=1e-4)
    mean, cov = weighted_moments(r.particles, r.log_weights)
    np.testing.assert_allclose(np.asarray(mean), np.zeros(3), atol=0.25)


def test_smc_log_gamma_evidence_via_reparam():
    """Round-5 composition (VERDICT r4 #8): the unconstraining transform
    layer feeds SMC a full-support density, so the Gaussian bridge is
    valid for the positive-support gamma family. Dropping the
    normalizer makes the evidence fully analytic:
    Z = [Gamma(shape)/rate^shape]^D for lp(y) = sum(shape*y - rate*e^y)."""
    from scipy.special import gammaln
    D, shape, rate = 4, 2.5, 1.0
    t = get_target("log_gamma_unconstrained", dim=D, shape=shape, rate=rate)

    # normalized target: log Z == 0 to MC error
    r0 = smc_run(random.PRNGKey(6), t.log_prob_fn, n_particles=2048, dim=D,
                 step_size=0.4, num_steps=8, base_scale=2.0,
                 value_and_grad_fn=t.value_and_grad_fn)
    assert abs(float(r0.log_Z)) < 0.06

    # unnormalized (normalizer added back): under the SAME key the weights
    # are identical, so the analytic constant Z = [Gamma(shape)/rate^shape]^D
    # must pass through the evidence estimate EXACTLY, and the absolute
    # error vs the analytic log Z is bounded by r0's MC error above
    const = D * (float(gammaln(shape)) + shape * np.log(rate))
    lp = lambda y: t.log_prob_fn(y) + const
    vag = lambda y: (t.value_and_grad_fn(y)[0] + const,
                     t.value_and_grad_fn(y)[1])
    r = smc_run(random.PRNGKey(6), lp, n_particles=2048, dim=D,
                step_size=0.4, num_steps=8, base_scale=2.0,
                value_and_grad_fn=vag)
    assert abs(float(r.log_Z) - float(r0.log_Z) - const) < 1e-6
    assert abs(float(r.log_Z) - const) < 0.06

    # transported population sits on the expGamma law: mean psi(shape)
    from scipy.special import digamma
    mean, _ = weighted_moments(r.particles, r.log_weights)
    np.testing.assert_allclose(np.asarray(mean),
                               np.full(D, digamma(shape) - np.log(rate)),
                               atol=0.2)


def test_smc_pallas_moves_cross_mesh_data_target():
    """Regression guard: the memoized fused-move factory caches padded vags
    and pallas_calls across calls; constants created inside one shard_map
    trace must not leak a Manual-mesh aval into a DIFFERENT mesh's trace.
    Exercise the exact sequence: mesh-8 trace first (populates the cache),
    then unsharded, then mesh-1. (The data-carrying hierarchical target
    has no kernel math, so the guard runs on the funnel's kernel.)"""
    from mcmc_tpu.parallel import make_mesh
    from mcmc_tpu.parallel.fused_sharded import smc_run_sharded

    t = get_target("neals_funnel", dim=9)
    kw = dict(dim=9, step_size=0.3, num_steps=4, move_steps=2,
              base_scale=1.5, betas=jnp.linspace(0.25, 1.0, 4),
              value_and_grad_fn=t.value_and_grad_fn,
              move_backend="interpret")

    r8 = smc_run_sharded(random.PRNGKey(8), t.log_prob_fn, make_mesh(8),
                         n_particles=1024, **kw)
    assert np.isfinite(float(r8.log_Z))
    ru = smc_run(random.PRNGKey(8), t.log_prob_fn, n_particles=1024, **kw)
    assert np.isfinite(float(ru.log_Z))
    r1 = smc_run_sharded(random.PRNGKey(8), t.log_prob_fn, make_mesh(1),
                         n_particles=1024, **kw)
    assert np.isfinite(float(r1.log_Z))
    # same fixed ladder everywhere: evidence estimates agree to MC error
    assert abs(float(r8.log_Z) - float(ru.log_Z)) < 1.5
    assert abs(float(r1.log_Z) - float(ru.log_Z)) < 1.5
