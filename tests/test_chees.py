"""ChEES trajectory-length adaptation (tuning/chees.py).

The reference has no counterpart (its trajectory length comes from a 7-run
L grid search, reference run_benchmarks.py:1055-1056); these tests pin the
tuner's own contracts: quasirandom jitter, Adam ascent, dynamic-trajectory
== static-trajectory parity, and convergence to the known quarter-period
optimum on Gaussian targets.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import random

from mcmc_tpu import get_target
from mcmc_tpu.samplers.trajectory import (
    integrate_trajectory, integrate_trajectory_dynamic)
from mcmc_tpu.samplers.base import make_value_and_grad
from mcmc_tpu.tuning.chees import (
    halton_sequence, chees_init, chees_update, num_leapfrog_steps,
    run_chees_warmup)


def test_halton_sequence_values_and_offset():
    h = halton_sequence(8)
    np.testing.assert_allclose(
        h, [0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875, 0.0625])
    assert (h > 0).all() and (h < 1).all()
    # offset continues the same stream (no repeated prefix)
    np.testing.assert_allclose(halton_sequence(4, offset=4),
                               halton_sequence(8)[4:])


def test_halton_low_discrepancy():
    h = halton_sequence(256)
    # each dyadic cell of width 1/16 contains exactly 16 of 256 points
    counts, _ = np.histogram(h, bins=16, range=(0.0, 1.0))
    assert (counts == 16).all()


def test_chees_adam_ascends_to_known_optimum():
    """Feed gradients of f(logT) = -(logT - c)^2; Adam must converge to c."""
    c = 1.7
    st = chees_init(1.0)
    for _ in range(600):
        g = -2.0 * (st.log_t - c)
        st = chees_update(st, g, lr=0.05)
    assert abs(float(st.log_t) - c) < 0.05


def test_num_leapfrog_steps_quantization():
    n = num_leapfrog_steps(jnp.asarray(0.95), 0.1, 256)
    assert int(n) == 10
    assert int(num_leapfrog_steps(jnp.asarray(0.0), 0.1, 256)) == 1
    assert int(num_leapfrog_steps(jnp.asarray(1e9), 0.1, 256)) == 256


@pytest.mark.parametrize("friction", [False, True])
def test_dynamic_trajectory_matches_static(friction):
    """integrate_trajectory_dynamic with a traced count must reproduce the
    static-scan integrator bit-for-bit (same substep structure)."""
    from mcmc_tpu.samplers.grahmc import tanh_schedule
    t = get_target("ill_conditioned_gaussian", dim=6)
    vag = make_value_and_grad(t.log_prob_fn, t.value_and_grad_fn)
    q = random.normal(random.PRNGKey(0), (32, 6))
    p = random.normal(random.PRNGKey(1), (32, 6))
    lp, grad = vag(q)
    inv_mass = jnp.linspace(0.5, 2.0, 6)
    kw = dict(friction_schedule=tanh_schedule, gamma_max=0.8,
              steepness=0.5) if friction else {}
    # both sides jitted: XLA's elementwise fusion differs between traced
    # and op-by-op execution at the 1-ulp level, which would mask a real
    # structural mismatch with a loose tolerance
    ref = jax.jit(lambda: integrate_trajectory(
        q, p, lp, grad, vag, 0.05, 13, inv_mass, **kw))()

    @jax.jit
    def dyn(n):
        return integrate_trajectory_dynamic(q, p, lp, grad, vag, 0.05, n,
                                            inv_mass, **kw)
    out = dyn(jnp.asarray(13))  # traced trip count
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_chees_converges_to_quarter_period_on_gaussian():
    """On N(0, I) the jittered-HMC ChEES optimum is the quarter period
    pi/2 ~ 1.57; the tuned T must land near it and the step near the
    0.651-acceptance point."""
    t = get_target("standard_normal", dim=16)
    init = random.normal(random.PRNGKey(1), (256, 16)) * 0.5
    step, inv_mass, pos, info = run_chees_warmup(
        "hmc", t.log_prob_fn, None, init, random.PRNGKey(0),
        num_warmup=1000, value_and_grad_fn=t.value_and_grad_fn,
        exploration_steps=200, adaptation_windows=[25, 50, 100, 200, 300],
        cooldown_steps=125)
    assert 1.0 < info["trajectory_length"] < 2.3
    assert info["num_steps"] >= 1
    assert not info["max_steps_cap_hit"]
    assert np.mean(info["accept_history"][-3:]) == pytest.approx(0.651, abs=0.08)
    assert pos.shape == init.shape and np.isfinite(np.asarray(pos)).all()
    # mass matrix learned ~identity here
    assert np.allclose(np.asarray(inv_mass), 1.0, atol=0.15)


def test_chees_trajectory_scales_with_target_scale():
    """With mass learning OFF, a sigma=2.5 isotropic Gaussian needs ~2.5x
    the unit-Gaussian trajectory time (period scales with sigma) — the
    criterion must track the target's scale."""
    t = get_target("standard_normal", dim=8)

    def scaled_lp(x):
        return t.log_prob_fn(x / 2.5) - 8 * jnp.log(2.5)

    init = random.normal(random.PRNGKey(1), (256, 8)) * 0.5
    kw = dict(num_warmup=700, exploration_steps=200,
              adaptation_windows=[50, 100, 200], cooldown_steps=150,
              learn_mass_matrix=False)
    _, _, _, info_unit = run_chees_warmup(
        "hmc", t.log_prob_fn, None, init, random.PRNGKey(0),
        value_and_grad_fn=t.value_and_grad_fn, **kw)
    _, _, _, info_scaled = run_chees_warmup(
        "hmc", scaled_lp, None, init * 2.5, random.PRNGKey(0), **kw)
    ratio = info_scaled["trajectory_length"] / info_unit["trajectory_length"]
    # nominal ratio 2.5; the band excludes "not tracking" (~1) and runaway
    # (>>sigma) but leaves room for stochastic-ascent variance
    assert 1.7 < ratio < 4.5, (info_unit, info_scaled)


def test_chees_grahmc_runs_and_converges():
    """GRAHMC (tanh friction) through the same tuner: finite products, a
    sane trajectory, acceptance on target."""
    t = get_target("standard_normal", dim=8)
    init = random.normal(random.PRNGKey(2), (128, 8)) * 0.5
    step, inv_mass, pos, info = run_chees_warmup(
        "grahmc", t.log_prob_fn, None, init, random.PRNGKey(0),
        num_warmup=600, schedule_type="tanh", gamma=0.5,
        value_and_grad_fn=t.value_and_grad_fn,
        exploration_steps=150, adaptation_windows=[50, 100, 200],
        cooldown_steps=100)
    assert step > 0 and np.isfinite(info["trajectory_length"])
    assert 0.4 < np.mean(info["accept_history"][-2:]) < 0.95
    assert np.isfinite(np.asarray(pos)).all()


def test_chees_rejects_unknown_sampler():
    with pytest.raises(ValueError):
        run_chees_warmup("nuts", lambda x: -jnp.sum(x * x, -1), None,
                         jnp.zeros((4, 2)), random.PRNGKey(0))


@pytest.mark.slow
def test_chees_jittered_efficiency_on_noncentered_funnel():
    """Production-semantics regression pin on the green-gate target (an
    earlier archived run measured chees at 16.3x the grid winner's
    ESS/gradient, a device-independent ratio — BASELINE.md): the tuner lands T in a sane band and
    JITTERED sampling at the tuned point clears an absolute min-dim
    bulk-ESS-per-leapfrog floor (measured ~10-20; floor 2 leaves 5x
    seed margin).

    Deliberately NOT a fixed-L-vs-jitter ESS/grad race: in the sampled
    coordinates this target is a diagonal Gaussian, where a fixed-L arm
    can land ANTITHETIC (measured ESS 4.3x N at L=2 — eps*L on a
    half-period) or dead purely by phase. Jitter trades that lottery for
    robustness — comparing against a lottery winner proves nothing."""
    from mcmc_tpu.diagnostics import ess_bulk
    from mcmc_tpu.tuning.chees import chees_run

    t = get_target("neals_funnel_noncentered", dim=10)
    init = random.normal(random.PRNGKey(1), (64, 10)) * 0.5
    step, inv_mass, pos, info = run_chees_warmup(
        "hmc", t.log_prob_fn, None, init, random.PRNGKey(0),
        num_warmup=800, exploration_steps=200,
        adaptation_windows=[50, 100, 200, 150], cooldown_steps=100,
        value_and_grad_fn=t.value_and_grad_fn)
    assert 1.5 < info["trajectory_length"] < 12.0, info["trajectory_length"]
    assert not info["max_steps_cap_hit"]

    res = chees_run(random.PRNGKey(9), t.log_prob_fn, pos, step,
                    info["trajectory_length"], 600, burn_in=100,
                    inv_mass_matrix=inv_mass,
                    value_and_grad_fn=t.value_and_grad_fn, backend="xla")
    ess = float(jnp.min(ess_bulk(res.samples)))
    eff = ess / res.info["total_leapfrogs"]
    assert eff > 2.0, (eff, ess, res.info["total_leapfrogs"])
    assert 0.45 < float(res.accept_rate.mean()) <= 1.0


@pytest.mark.slow
def test_chees_drives_long_trajectories_on_rosenbrock():
    """On the curved Rosenbrock valley the ChEES criterion genuinely
    favors LONG trajectories (squared jump distance keeps growing along
    the valley) with seed-variable outcomes — measured T in {9.1, 22.2,
    21.7} across seeds 0/7/42 at this 800-step budget. Pin the direction
    (T well above the quarter-period scale of the valley cross-section)
    and that jittered sampling at the tuned point stays statistically
    sound. A one-number trajectory tuner is NOT universally optimal on
    such geometry — which is exactly why the CLI keeps the reference L
    grid as the default and the chees mode auto-falls-back on cap."""
    from mcmc_tpu.diagnostics import ess_bulk
    from mcmc_tpu.tuning.chees import chees_run

    t = get_target("rosenbrock", dim=10)
    init = random.normal(random.PRNGKey(1), (64, 10)) * 0.1
    step, inv_mass, pos, info = run_chees_warmup(
        "hmc", t.log_prob_fn, None, init, random.PRNGKey(7),
        num_warmup=800, exploration_steps=200,
        adaptation_windows=[50, 100, 200, 150], cooldown_steps=100,
        value_and_grad_fn=t.value_and_grad_fn)
    assert info["trajectory_length"] > 3.0, info["trajectory_length"]

    res = chees_run(random.PRNGKey(9), t.log_prob_fn, pos, step,
                    info["trajectory_length"], 300, burn_in=50,
                    inv_mass_matrix=inv_mass,
                    value_and_grad_fn=t.value_and_grad_fn, backend="xla")
    assert np.isfinite(np.asarray(res.samples)).all()
    assert 0.3 < float(res.accept_rate.mean()) <= 1.0
    assert float(jnp.min(ess_bulk(res.samples))) > 50.0


@pytest.mark.slow
def test_chees_flags_runaway_on_flat_tailed_target():
    """log_gamma's near-linear left tail makes the ChEES criterion grow
    monotonically in T (leapfrog is exact on linear potentials, so the
    runaway costs no acceptance); the tuner must hit the trajectory cap
    AND report it via max_steps_cap_hit so callers can fall back to the
    grid search."""
    t = get_target("log_gamma", dim=10)
    init = random.normal(random.PRNGKey(1), (64, 10)) * 0.1
    step, _, pos, info = run_chees_warmup(
        "hmc", t.log_prob_fn, None, init, random.PRNGKey(0),
        num_warmup=600, exploration_steps=150,
        adaptation_windows=[50, 100, 200], cooldown_steps=100,
        value_and_grad_fn=t.value_and_grad_fn, max_steps=64)
    assert info["max_steps_cap_hit"] is True
    assert info["num_steps"] == 64
    assert np.isfinite(np.asarray(pos)).all() and step > 0


# ----------------------------------------------------------------------------
# chees_run: jittered-trajectory sampling at the tuned operating point
# ----------------------------------------------------------------------------

def test_chees_run_validates_inputs():
    from mcmc_tpu.tuning.chees import chees_run
    t = get_target("standard_normal", dim=2)
    with pytest.raises(ValueError):
        chees_run(random.PRNGKey(0), t.log_prob_fn, jnp.zeros((4, 2)),
                  step_size=0.0, trajectory_length=1.0, num_samples=10)
    with pytest.raises(ValueError):
        chees_run(random.PRNGKey(0), t.log_prob_fn, jnp.zeros((4, 2)),
                  step_size=0.3, trajectory_length=-1.0, num_samples=10)


@pytest.mark.slow
def test_chees_run_xla_moments_and_gradient_accounting():
    """Jittered sampling on a standard normal: correct posterior moments,
    and the reported leapfrog accounting matches the realized per-draw
    counts (the REAL gradient count — jittered draws are cheaper than
    num_samples * L_max)."""
    from mcmc_tpu.tuning.chees import chees_run
    dim = 6
    t = get_target("standard_normal", dim=dim)
    init = random.normal(random.PRNGKey(0), (64, dim))
    T = float(np.pi / 2)      # quarter period: the ChEES optimum here
    res = chees_run(random.PRNGKey(1), t.log_prob_fn, init, step_size=0.45,
                    trajectory_length=T, num_samples=500, burn_in=100,
                    value_and_grad_fn=t.value_and_grad_fn, backend="xla")
    ns = res.info["num_steps_per_draw"]
    assert ns.shape == (500,) and ns.min() >= 1
    assert res.info["total_leapfrogs"] == int(ns.sum())
    # jitter quantizes t = h * T upward: every draw is at most ceil(T/eps)
    assert ns.max() <= int(np.ceil(T / 0.45))
    assert res.info["jitter_backend"] == "xla"
    assert 0.6 < float(res.accept_rate.mean()) <= 1.0
    assert int(res.info["total_divergences"]) == 0
    s = np.asarray(res.samples).reshape(-1, dim)
    assert abs(s.mean()) < 0.05
    assert abs(s.var() - 1.0) < 0.12


@pytest.mark.slow
def test_chees_run_pallas_quantized_jitter_interpret():
    """The Pallas backend bins the jitter into <= jitter_levels static
    trajectory lengths (one fused kernel each); realized per-draw counts
    must come from exactly that level set. Runs in interpreter mode on CPU
    (same kernel body as on the GPU)."""
    from mcmc_tpu.tuning.chees import chees_run
    t = get_target("standard_normal", dim=4)
    init = random.normal(random.PRNGKey(2), (8, 4)).astype(jnp.float32)
    res = chees_run(random.PRNGKey(3), t.log_prob_fn, init, step_size=0.4,
                    trajectory_length=2.0, num_samples=48,
                    value_and_grad_fn=t.value_and_grad_fn,
                    backend="interpret", jitter_levels=3)
    Ls = res.info["jitter_level_steps"]
    assert 1 <= len(Ls) <= 3
    ns = res.info["num_steps_per_draw"]
    assert set(np.unique(ns).tolist()) <= set(Ls)
    assert res.info["total_leapfrogs"] == int(ns.sum())
    assert np.isfinite(np.asarray(res.samples)).all()
    assert 0.0 < float(res.accept_rate.mean()) <= 1.0


@pytest.mark.slow
def test_chees_run_grahmc_friction_moments():
    """chees_run with a friction schedule (GRAHMC) keeps the posterior
    exact — conformal leapfrog + MH is still in detailed balance at any
    jittered length."""
    from mcmc_tpu.tuning.chees import chees_run
    dim = 4
    t = get_target("standard_normal", dim=dim)
    init = random.normal(random.PRNGKey(4), (64, dim))
    res = chees_run(random.PRNGKey(5), t.log_prob_fn, init, step_size=0.4,
                    trajectory_length=1.6, num_samples=500, burn_in=100,
                    value_and_grad_fn=t.value_and_grad_fn, backend="xla",
                    schedule_type="tanh", gamma=0.5, steepness=5.0)
    s = np.asarray(res.samples).reshape(-1, dim)
    assert abs(s.mean()) < 0.06
    assert abs(s.var() - 1.0) < 0.15


def test_scale_default_schedule_budgets():
    from mcmc_tpu.tuning.chees import scale_default_schedule
    from mcmc_tpu.tuning.adaptation import build_schedule

    for n in (2500, 1000, 300, 100, 40, 10):
        e, ws, c = scale_default_schedule(n)
        total = e + sum(ws) + c
        assert total == n, (n, e, ws, c)
        assert e >= 1 and c >= 1 and all(w >= 1 for w in ws)
        sched = build_schedule(n, exploration_steps=e,
                               adaptation_windows=ws, cooldown_steps=c)
        assert sched[-1][1] == n
    # the 2500 budget reproduces the Stan-style default exactly
    assert scale_default_schedule(2500) == (500, [25, 50, 100, 200, 500,
                                                  1000], 125)


# ----------------------------------------------------------------------------
# Mesh (multi-chip) paths — 8 virtual CPU devices via conftest
# ----------------------------------------------------------------------------

@pytest.mark.slow
def test_chees_warmup_under_mesh_converges():
    """run_chees_warmup(mesh=...) shard_maps the window scans (cross-chain
    criterion moments psum'd over the mesh axis); the tuned T on N(0, I)
    must still land near the quarter-period optimum and the mass matrix
    near identity — same contract as the single-device convergence test."""
    from mcmc_tpu.parallel import make_mesh, shard_chains

    t = get_target("standard_normal", dim=8)
    mesh = make_mesh()
    assert mesh.devices.size == 8
    init = shard_chains(
        random.normal(random.PRNGKey(1), (256, 8)) * 0.5, mesh)
    step, inv_mass, pos, info = run_chees_warmup(
        "hmc", t.log_prob_fn, None, init, random.PRNGKey(0),
        num_warmup=1000, value_and_grad_fn=t.value_and_grad_fn,
        exploration_steps=200, adaptation_windows=[25, 50, 100, 200, 300],
        cooldown_steps=125, mesh=mesh)
    assert 1.0 < info["trajectory_length"] < 2.3
    assert not info["max_steps_cap_hit"]
    assert np.mean(info["accept_history"][-3:]) == pytest.approx(0.651,
                                                                 abs=0.08)
    assert pos.shape == (256, 8) and np.isfinite(np.asarray(pos)).all()
    assert np.allclose(np.asarray(inv_mass), 1.0, atol=0.15)


@pytest.mark.slow
def test_chees_run_under_mesh_moments_and_sharding():
    """chees_run(mesh=...) shard_maps the jittered sampling scan: the full
    sharded history has correct posterior moments, the realized leapfrog
    stream is the replicated host-side one, and the output history is
    chain-sharded over the mesh."""
    from mcmc_tpu.parallel import CHAIN_AXIS, make_mesh, shard_chains
    from mcmc_tpu.tuning.chees import chees_run

    dim = 6
    t = get_target("standard_normal", dim=dim)
    mesh = make_mesh()
    init = shard_chains(random.normal(random.PRNGKey(2), (128, dim)), mesh)
    res = chees_run(random.PRNGKey(3), t.log_prob_fn, init, step_size=0.45,
                    trajectory_length=float(np.pi / 2), num_samples=400,
                    burn_in=100, value_and_grad_fn=t.value_and_grad_fn,
                    backend="xla", mesh=mesh)
    assert res.samples.shape == (400, 128, dim)
    spec = res.samples.sharding.spec
    assert CHAIN_AXIS in tuple(spec), spec
    ns = res.info["num_steps_per_draw"]
    assert res.info["total_leapfrogs"] == int(ns.sum())
    s = np.asarray(res.samples).reshape(-1, dim)
    assert abs(s.mean()) < 0.05
    assert abs(s.var() - 1.0) < 0.1
    assert 0.5 < float(res.accept_rate.mean()) <= 1.0


@pytest.mark.slow
def test_chees_run_pallas_under_mesh_interpret():
    """The quantized-jitter Pallas backend composes with the mesh: each
    device lax.switches into fused kernels built at its LOCAL chain width
    (pallas_call is opaque to GSPMD — this is the path a multi-GPU CLI
    run takes for the sampling phase). Interpreter mode on CPU."""
    from mcmc_tpu.parallel import make_mesh, shard_chains
    from mcmc_tpu.tuning.chees import chees_run

    t = get_target("standard_normal", dim=4)
    mesh = make_mesh()
    init = shard_chains(
        random.normal(random.PRNGKey(4), (32, 4)).astype(jnp.float32), mesh)
    res = chees_run(random.PRNGKey(5), t.log_prob_fn, init, step_size=0.4,
                    trajectory_length=1.6, num_samples=24,
                    value_and_grad_fn=t.value_and_grad_fn,
                    backend="interpret", jitter_levels=3, mesh=mesh)
    assert res.samples.shape == (24, 32, 4)
    ns = res.info["num_steps_per_draw"]
    assert set(np.unique(ns).tolist()) <= set(res.info["jitter_level_steps"])
    assert np.isfinite(np.asarray(res.samples)).all()
    assert 0.0 < float(res.accept_rate.mean()) <= 1.0


def test_plot_chees_history(tmp_path):
    from mcmc_tpu.tuning.plots import plot_chees_history
    info = {"log_t_history": list(np.linspace(-1.8, 0.45, 25)),
            "mean_leapfrogs_history": list(np.linspace(1, 9, 25)),
            "accept_history": list(0.65 + 0.1 * np.sin(np.arange(25))),
            "trajectory_length": 1.57, "num_steps": 7,
            "target_accept": 0.651}
    out = tmp_path / "chees.png"
    plot_chees_history(info, "HMC", str(out))
    assert out.exists() and out.stat().st_size > 5000
    with pytest.raises(ValueError):
        plot_chees_history({"accept_history": []})


def test_chees_cap_reflag_on_post_retune_overflow(monkeypatch):
    """GRAHMC phase-3 friction tuning can RETUNE the step size smaller; if
    the equivalent leapfrog count round(T/step_new) then overflows
    max_steps, sampling would silently truncate every long-jitter draw —
    the warmup must re-flag max_steps_cap_hit so callers fall back to the
    grid (review finding: the pre-clip cap check alone missed this)."""
    import mcmc_tpu.tuning.sequential as seq_mod

    def fake_seq(**kw):
        # a friction tuner that slashes the step by 100x
        return kw["init_step_size"] * 0.01, 0.5, 1.0, {}

    monkeypatch.setattr(seq_mod, "sequential_tune_grahmc", fake_seq)
    t = get_target("standard_normal", dim=4)
    init = random.normal(random.PRNGKey(1), (32, 4)) * 0.5
    step, _, _, info = run_chees_warmup(
        "grahmc", t.log_prob_fn, None, init, random.PRNGKey(0),
        num_warmup=200, schedule_type="constant",
        value_and_grad_fn=t.value_and_grad_fn, max_steps=16)
    assert info["num_steps"] > 16
    assert info["max_steps_cap_hit"] is True


def test_chees_warmup_compiles_one_batch_program(caplog):
    """Compile-shape canary for the ChEES driver (mirror of the grid
    warmup's test_warmup_compiles_two_batch_programs): the whole warmup —
    mixed window widths, all three phases — must compile exactly ONE
    run_batch program (the accumulate flag is traced here)."""
    import logging

    t = get_target("standard_normal", dim=5)
    init = random.normal(random.PRNGKey(3), (8, 5)) * 0.1
    jax.config.update("jax_log_compiles", True)
    try:
        with caplog.at_level(logging.WARNING,
                             logger="jax._src.interpreters.pxla"):
            run_chees_warmup(
                "hmc", t.log_prob_fn, None, init, random.PRNGKey(0),
                num_warmup=425, value_and_grad_fn=t.value_and_grad_fn,
                exploration_steps=100, adaptation_windows=[25, 50, 125],
                cooldown_steps=125)
    finally:
        jax.config.update("jax_log_compiles", False)
    compiles = [r.message for r in caplog.records
                if "Compiling jit(_batch_core)" in r.message]
    assert len(compiles) == 1, compiles


def test_chees_run_caches_across_offsets(caplog):
    """Repeated chees_run calls on the SAME target with a DIFFERENT jitter
    offset must hit the module-level jit cache — the per-draw step counts
    are a traced operand, not baked-in constants (review finding: a fresh
    per-call jax.jit(closure) recompiled on every invocation, one full XLA
    compile per bench rep / convergence checkpoint)."""
    import logging
    from mcmc_tpu.tuning.chees import chees_run

    t = get_target("standard_normal", dim=4)
    init = random.normal(random.PRNGKey(2), (16, 4))
    kw = dict(step_size=0.5, trajectory_length=1.5, num_samples=64,
              value_and_grad_fn=t.value_and_grad_fn, backend="xla")
    jax.config.update("jax_log_compiles", True)
    try:
        with caplog.at_level(logging.WARNING,
                             logger="jax._src.interpreters.pxla"):
            chees_run(random.PRNGKey(0), t.log_prob_fn, init,
                      halton_offset=0, **kw)
            n_first = sum("Compiling jit(_chees_run_core)" in r.message
                          for r in caplog.records)
            chees_run(random.PRNGKey(1), t.log_prob_fn, init,
                      halton_offset=9999, **kw)
    finally:
        jax.config.update("jax_log_compiles", False)
    n_total = sum("Compiling jit(_chees_run_core)" in r.message
                  for r in caplog.records)
    assert n_first == 1, "first call must compile the core"
    assert n_total == n_first, "second call (new offset) must hit the cache"


def test_joint_gamma_tuner_validation():
    """gamma_tuner surface contract: bad value and joint+dense both raise."""
    from mcmc_tpu.tuning.chees import run_chees_warmup
    t = get_target("standard_normal", dim=3)
    init = random.normal(random.PRNGKey(0), (8, 3))
    kw = dict(num_warmup=40, value_and_grad_fn=t.value_and_grad_fn,
              schedule_type="tanh")
    with pytest.raises(ValueError, match="gamma_tuner"):
        run_chees_warmup("grahmc", t.log_prob_fn, None, init,
                         random.PRNGKey(1), gamma_tuner="spsa", **kw)
    with pytest.raises(ValueError, match="diagonal"):
        run_chees_warmup("grahmc", t.log_prob_fn, None, init,
                         random.PRNGKey(1), gamma_tuner="joint",
                         learn_mass_matrix="dense", **kw)


def test_joint_gamma_tuner_single_phase():
    """gamma_tuner='joint' produces (eps, M, T, gamma) in ONE warmup: the
    SPSA iterate moves off its init, lands strictly inside the clip
    bounds, the separate grid phase is skipped (info says so), and the
    default-path ('grid') results are untouched by the new carry."""
    from mcmc_tpu.tuning.chees import (GAMMA_MAX, GAMMA_MIN,
                                       run_chees_warmup)
    t = get_target("neals_funnel", dim=6)
    init = t.init_sampler(random.PRNGKey(0), 64).astype(jnp.float32)
    step, mass, pos, info = run_chees_warmup(
        "grahmc", t.log_prob_fn, None, init, random.PRNGKey(1),
        num_warmup=400, schedule_type="tanh",
        value_and_grad_fn=t.value_and_grad_fn, gamma_tuner="joint")
    assert info["gamma_tuner"] == "joint"
    assert info["gamma_fallback_to_grid"] is False
    assert GAMMA_MIN < info["gamma"] < GAMMA_MAX
    lg = info["log_gamma_history"]
    assert len(lg) >= 3 and all(np.isfinite(lg))
    # the iterate actually adapted (funnel ESJD is gamma-sensitive)
    assert abs(lg[-1] - lg[0]) > 1e-4
    assert step > 0 and np.all(np.isfinite(np.asarray(mass)))
    assert np.all(np.isfinite(np.asarray(pos)))


def test_joint_gamma_tuner_under_mesh():
    """Joint friction SPSA under the 8-device mesh: probe sums are pmean'd
    per step, so the replicated iterate stays finite/interior and the
    warmup completes through the shard_mapped batch program."""
    from mcmc_tpu.parallel import make_mesh, shard_chains
    from mcmc_tpu.tuning.chees import (GAMMA_MAX, GAMMA_MIN,
                                       run_chees_warmup)
    mesh = make_mesh(8)
    t = get_target("standard_normal", dim=4)
    init = shard_chains(
        random.normal(random.PRNGKey(3), (32, 4)) * 0.5, mesh)
    step, mass, pos, info = run_chees_warmup(
        "grahmc", t.log_prob_fn, None, init, random.PRNGKey(4),
        num_warmup=200, schedule_type="constant",
        value_and_grad_fn=t.value_and_grad_fn, gamma_tuner="joint",
        mesh=mesh)
    assert info["gamma_tuner"] in ("joint", "grid")   # fallback allowed
    assert GAMMA_MIN <= info["gamma"] <= GAMMA_MAX
    assert np.all(np.isfinite(info["log_gamma_history"]))
    assert pos.shape == (32, 4)


def test_gamma_spsa_update_math():
    """Unit contract of the RM step: ascends when E+ > E-, descends when
    E+ < E-, freezes on a degenerate batch, clips at the bounds."""
    from mcmc_tpu.tuning.chees import (GAMMA_MAX, GAMMA_SPSA_DELTA,
                                       GAMMA_SPSA_LR, GammaSPSAState,
                                       gamma_spsa_batch_update,
                                       gamma_spsa_init)
    gs = gamma_spsa_init(1.0)
    up = gamma_spsa_batch_update(gs._replace(
        sum_p=jnp.asarray(4.0), n_p=jnp.asarray(2.0),
        sum_m=jnp.asarray(2.0), n_m=jnp.asarray(2.0)))
    expect = GAMMA_SPSA_LR * np.log(2.0) / (2 * GAMMA_SPSA_DELTA)
    assert float(up.log_gamma) == pytest.approx(expect, rel=1e-5)
    down = gamma_spsa_batch_update(gs._replace(
        sum_p=jnp.asarray(1.0), n_p=jnp.asarray(2.0),
        sum_m=jnp.asarray(2.0), n_m=jnp.asarray(2.0)))
    assert float(down.log_gamma) < 0
    # degenerate: one side empty -> iterate unchanged, sums reset
    frozen = gamma_spsa_batch_update(gs._replace(
        sum_p=jnp.asarray(4.0), n_p=jnp.asarray(2.0)))
    assert float(frozen.log_gamma) == float(gs.log_gamma)
    assert float(frozen.sum_p) == 0.0
    # clip: a huge repeated ascent cannot exceed log(GAMMA_MAX)
    g = gamma_spsa_init(15.0)
    for _ in range(20):
        g = gamma_spsa_batch_update(g._replace(
            sum_p=jnp.asarray(1e6), n_p=jnp.asarray(2.0),
            sum_m=jnp.asarray(1.0), n_m=jnp.asarray(2.0)))
    assert float(jnp.exp(g.log_gamma)) == pytest.approx(GAMMA_MAX, rel=1e-5)
