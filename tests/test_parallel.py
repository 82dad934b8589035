"""Multi-chip sharding tests on the 8-device virtual CPU mesh.

Chains are communication-free, so the whole sampler partitions under GSPMD;
diagnostics reductions over the sharded history become collectives. These
tests assert both that sharded runs execute AND that sharding actually
propagates (output committed to the expected sharding), plus bitwise
consistency with the unsharded run.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import jax.random as random
from jax.sharding import NamedSharding, PartitionSpec as P

from mcmc_tpu.parallel import make_mesh, shard_chains, chain_sharding
from mcmc_tpu.targets import standard_normal, neals_funnel
from mcmc_tpu.samplers import grahmc_run, nuts_run, get_friction_schedule
from mcmc_tpu.diagnostics import split_rhat, ess_bulk


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_grahmc_sharded_runs_and_matches_unsharded():
    t = standard_normal(6)
    mesh = make_mesh()
    init = random.normal(random.PRNGKey(0), (16, 6))
    kw = dict(step_size=0.3, num_steps=5, gamma=0.5, steepness=2.0,
              num_samples=30, burn_in=10,
              friction_schedule=get_friction_schedule("tanh"),
              value_and_grad_fn=t.value_and_grad_fn)

    r_plain = grahmc_run(random.PRNGKey(1), t.log_prob_fn, init, **kw)

    init_sharded = shard_chains(init, mesh)
    r_shard = grahmc_run(random.PRNGKey(1), t.log_prob_fn, init_sharded, **kw)

    # Same results regardless of sharding (partitionable threefry).
    np.testing.assert_allclose(np.asarray(r_plain.samples),
                               np.asarray(r_shard.samples), rtol=1e-12)
    # Output actually sharded over chains.
    shard_axes = {s.index[1] for s in r_shard.samples.addressable_shards}
    assert len(shard_axes) == 8  # 8 distinct chain slices


def test_nuts_sharded_runs():
    t = standard_normal(4)
    mesh = make_mesh()
    init = shard_chains(random.normal(random.PRNGKey(2), (16, 4)), mesh)
    res = nuts_run(random.PRNGKey(3), t.log_prob_fn, init, step_size=0.4,
                   num_samples=20, burn_in=5, max_tree_depth=6,
                   value_and_grad_fn=t.value_and_grad_fn)
    assert res.samples.shape == (20, 16, 4)
    assert np.all(np.isfinite(np.asarray(res.samples)))


def test_diagnostics_on_sharded_history():
    """Cross-chain reductions (the only collectives) work on sharded samples."""
    mesh = make_mesh()
    samples = random.normal(random.PRNGKey(4), (500, 16, 3))
    sharded = jax.device_put(samples, NamedSharding(mesh, P(None, "chains", None)))
    rhat = split_rhat(sharded)
    ess = ess_bulk(sharded)
    np.testing.assert_allclose(np.asarray(rhat), np.asarray(split_rhat(samples)),
                               rtol=1e-10)
    assert np.all(np.asarray(ess) > 0)


def test_sliced_w2_on_sharded_history_matches_unsharded():
    """W2 gathers mesh-sharded histories to one device before the projected
    sorts (wasserstein._unshard): the sharded result must be EXACTLY the
    unsharded one, and must not fall into the GSPMD global-sort path
    (measured 257s/call vs 24s before the fix)."""
    from mcmc_tpu.diagnostics import compute_sliced_w2, ConvergenceW2Tracker
    mesh = make_mesh()
    samples = random.normal(random.PRNGKey(7), (200, 16, 4))
    sharded = jax.device_put(
        samples, NamedSharding(mesh, P(None, "chains", None)))
    kw = dict(n_reference=5000, n_projections=50, key=random.PRNGKey(8))
    w2_plain = compute_sliced_w2(samples, "standard_normal", 4, **kw)
    w2_shard = compute_sliced_w2(sharded, "standard_normal", 4, **kw)
    assert w2_plain == w2_shard
    tr = ConvergenceW2Tracker("standard_normal", 4, n_reference=5000,
                              n_projections=50, key=random.PRNGKey(9))
    assert tr.w2(sharded) == tr.w2(samples)


@pytest.mark.slow
def test_full_pipeline_sharded_funnel():
    """Warmup + sample + diagnose with chains sharded over the mesh."""
    from mcmc_tpu.tuning import run_adaptive_warmup
    t = neals_funnel(4)
    mesh = make_mesh()
    init = shard_chains(t.init_sampler(random.PRNGKey(5), 16), mesh)
    step, inv_mass, pos, info = run_adaptive_warmup(
        "grahmc", t.log_prob_fn, None, init, random.PRNGKey(6),
        num_warmup=300, schedule_type="constant", num_steps=5,
        max_iter_step=50, gamma_samples_per_eval=20,
        value_and_grad_fn=t.value_and_grad_fn)
    res = grahmc_run(random.PRNGKey(7), t.log_prob_fn, pos, step_size=step,
                     num_steps=5, gamma=info["gamma"], steepness=info["steepness"],
                     num_samples=50, burn_in=0, inv_mass_matrix=inv_mass,
                     value_and_grad_fn=t.value_and_grad_fn)
    assert np.all(np.isfinite(np.asarray(res.samples)))


@pytest.mark.slow
def test_config5_hierarchical_pipeline_sharded():
    """BASELINE config 5 shape: hierarchical logistic posterior, full
    tune+sample+diagnostics with chains sharded over the mesh (tiny sizes)."""
    from mcmc_tpu.targets import get_target
    from mcmc_tpu.tuning import run_adaptive_warmup
    from mcmc_tpu.diagnostics import compute_diagnostics

    t = get_target("hierarchical_logistic", dim=12, n_data=32)
    mesh = make_mesh()
    init = shard_chains(t.init_sampler(random.PRNGKey(20), 16), mesh)
    step, inv_mass, pos, info = run_adaptive_warmup(
        "grahmc", t.log_prob_fn, None, init, random.PRNGKey(21),
        num_warmup=300, schedule_type="tanh", num_steps=6,
        max_iter_step=50, gamma_samples_per_eval=20,
        value_and_grad_fn=t.value_and_grad_fn)
    res = grahmc_run(random.PRNGKey(22), t.log_prob_fn, pos, step_size=step,
                     num_steps=6, gamma=info["gamma"], steepness=info["steepness"],
                     num_samples=100, burn_in=0, inv_mass_matrix=inv_mass,
                     friction_schedule=get_friction_schedule("tanh"),
                     value_and_grad_fn=t.value_and_grad_fn)
    d = compute_diagnostics(res.samples)
    assert np.isfinite(d["rhat_max"]) and d["ess_bulk_min"] > 0
    assert np.all(np.isfinite(np.asarray(res.samples)))


def test_fused_kernel_sharded_over_mesh():
    """The Pallas fused sampler runs under shard_map over the 8-device mesh
    (GSPMD cannot partition pallas_call; this is the explicit multi-chip
    path). Statistical sanity on N(0, I)."""
    from mcmc_tpu.parallel.fused_sharded import grahmc_run_sharded
    from mcmc_tpu.targets import standard_normal

    t = standard_normal(6)
    mesh = make_mesh()
    init = random.normal(random.PRNGKey(30), (64, 6)) * 0.5
    res = grahmc_run_sharded(
        random.PRNGKey(31), t, init, mesh, step_size=0.25, num_steps=6,
        gamma=0.3, steepness=1.0, num_samples=300, burn_in=100,
        collect_chains_per_device=4, backend="interpret")
    # history: 4 chains per device x 8 devices
    assert res.samples.shape == (300, 32, 6)
    assert res.accept_rate.shape == (64,)
    acc = float(res.accept_rate.mean())
    assert 0.3 < acc <= 1.0
    flat = np.asarray(res.samples).reshape(-1, 6)
    assert np.all(np.abs(flat.mean(0)) < 0.2)
    assert np.all(np.abs(flat.var(0) - 1.0) < 0.3)
    assert int(res.info["total_divergences"]) == 0
    assert res.info["final_positions"].shape == (64, 6)


def test_tempered_sharded_over_mesh():
    """Replica exchange under the chain mesh: swaps act only along the
    temperature axis, so every exchange is device-local — the sampling loop
    stays collective-free and only the final diagnostic psums cross devices.
    Cold-replica moments stay exact; ladder continuation round-trips
    through the sharded layout."""
    from mcmc_tpu.parallel.fused_sharded import tempered_run_sharded
    from mcmc_tpu.targets import standard_normal

    t = standard_normal(4)
    mesh = make_mesh()
    init = random.normal(random.PRNGKey(40), (64, 4)) * 0.3
    res = tempered_run_sharded(
        random.PRNGKey(41), t, init, mesh, step_size=0.5, num_steps=8,
        num_samples=400, n_temps=4)
    assert res.samples.shape == (400, 64, 4)
    flat = np.asarray(res.samples[100:]).reshape(-1, 4)
    assert np.all(np.abs(flat.mean(0)) < 0.15)
    assert np.all(np.abs(flat.var(0) - 1.0) < 0.2)
    sw = np.asarray(res.info["swap_accept_rate"])
    assert sw.shape == (3,) and np.all((sw > 0.05) & (sw < 1.0))
    assert np.asarray(res.info["replica_accept_rate"]).shape == (4,)
    assert int(res.info["n_devices"]) == 8
    rep = res.info["replica_final_positions"]
    assert rep.shape == (4 * 64, 4)
    # continuation: the device-major replica layout round-trips exactly
    res2 = tempered_run_sharded(
        random.PRNGKey(42), t, init, mesh, step_size=0.5, num_steps=8,
        num_samples=50, n_temps=4, replica_position=rep)
    assert res2.samples.shape == (50, 64, 4)
    rep2 = np.asarray(res2.info["replica_final_positions"])
    # hot rows (pi^0.05 = N(0, 20)) stay overdispersed through the restart:
    # per-device blocks are replica-major, so hot rows are each block's tail
    hot = rep2.reshape(8, 4, 8, 4)[:, -1]              # (dev, C_local, D)
    cold = rep2.reshape(8, 4, 8, 4)[:, 0]
    assert hot.var() > 4.0 * cold.var(), (hot.var(), cold.var())


def test_tempered_sharded_explicit_betas():
    """An explicit (tuned) ladder overrides the geometric default under the
    mesh: betas replicate across devices as a traced operand (n_temps
    derived from its length) and surface verbatim in the row's info."""
    from mcmc_tpu.parallel.fused_sharded import tempered_run_sharded
    from mcmc_tpu.targets import standard_normal

    t = standard_normal(3)
    mesh = make_mesh()
    init = random.normal(random.PRNGKey(50), (32, 3)) * 0.3
    betas = jnp.asarray([1.0, 0.55, 0.2, 0.06], jnp.float32)
    res = tempered_run_sharded(
        random.PRNGKey(51), t, init, mesh, step_size=0.5, num_steps=6,
        num_samples=60, n_temps=2,      # overridden by len(betas) == 4
        betas=betas)
    np.testing.assert_allclose(np.asarray(res.info["betas"]),
                               np.asarray(betas), rtol=1e-6)
    assert np.asarray(res.info["swap_accept_rate"]).shape == (3,)
    assert res.info["replica_final_positions"].shape == (4 * 32, 3)
    assert np.all(np.isfinite(np.asarray(res.samples)))


def test_distributed_helpers_single_process():
    """Multi-host helpers degrade gracefully to single-process: initialize()
    is a no-op returning process 0; make_chain_mesh spans all local devices
    on one named chain axis."""
    from mcmc_tpu.parallel.distributed import initialize, make_chain_mesh
    assert initialize(num_processes=1) == 0
    mesh = make_chain_mesh()
    assert mesh.axis_names == ("chains",)
    assert mesh.devices.size == len(jax.devices())


def test_persistent_nuts_sharded_over_mesh():
    """Persistent NUTS is pure batched jnp — GSPMD partitions it over the
    chain mesh from sharded inputs alone (no collectives in the hot loop)."""
    from mcmc_tpu.parallel import make_mesh, shard_chains
    from mcmc_tpu.samplers import nuts_run_persistent
    from mcmc_tpu.targets import standard_normal

    t = standard_normal(4)
    mesh = make_mesh(8)
    pos = shard_chains(
        random.normal(random.PRNGKey(0), (32, 4)), mesh)
    res = nuts_run_persistent(random.PRNGKey(1), t.log_prob_fn, pos,
                              step_size=0.5, num_samples=30,
                              steps_per_sample=8, burn_in_steps=16,
                              value_and_grad_fn=t.value_and_grad_fn)
    assert res.samples.shape == (30, 32, 4)
    flat = np.asarray(res.samples).reshape(-1, 4)
    assert np.all(np.isfinite(flat))
    assert np.all(np.abs(flat.mean(0)) < 0.6)


def test_fused_persistent_nuts_sharded_over_mesh():
    """The persistent-NUTS XLA machine runs shard_mapped over the 8-device
    mesh (one machine per device on its chain shard). Statistical sanity +
    info schema on N(0, I)."""
    from mcmc_tpu.parallel import make_mesh
    from mcmc_tpu.parallel.fused_sharded import nuts_persistent_run_sharded
    from mcmc_tpu.targets import standard_normal

    t = standard_normal(5)
    mesh = make_mesh()
    init = (random.normal(random.PRNGKey(40), (32, 5)) * 0.3
            ).astype(jnp.float32)
    res = nuts_persistent_run_sharded(
        random.PRNGKey(41), t, init, mesh, step_size=0.4, num_samples=40,
        steps_per_sample=16, burn_in_steps=16, collect_chains_per_device=2)
    assert res.samples.shape == (40, 16, 5)   # 2 chains/device x 8 devices
    assert res.accept_rate.shape == (32,)
    assert res.final_state.position.shape == (32, 5)
    for key_name in ("transitions", "mean_accept_probs", "mean_tree_depth",
                     "divergence_count"):
        assert res.info[key_name].shape == (32,), key_name
    assert int(res.info["n_devices"]) == mesh.devices.size
    # global totals are psummed, not per-shard
    slots = (16 + 40 * 16) * 32
    assert int(res.info["n_leapfrog_slots"]) == slots
    assert 0 < int(res.info["n_leapfrogs"]) <= slots
    assert np.all(np.asarray(res.info["transitions"]) >= 1)
    flat = np.asarray(res.samples).reshape(-1, 5)
    assert np.all(np.isfinite(flat))
    assert np.all(np.abs(flat.mean(0)) < 0.3)
    assert np.all(np.abs(flat.var(0) - 1.0) < 0.4)


def test_fused_persistent_nuts_multinomial_sharded_over_mesh():
    """The Stan multinomial proposal scheme runs through the same fused
    shard_map path (reservoir + checkpoint stacks live per-device in
    machine state); the CLI's mesh dispatch forwards --nuts-proposal here."""
    from mcmc_tpu.parallel import make_mesh
    from mcmc_tpu.parallel.fused_sharded import nuts_persistent_run_sharded
    from mcmc_tpu.targets import standard_normal

    t = standard_normal(5)
    mesh = make_mesh()
    init = (random.normal(random.PRNGKey(40), (32, 5)) * 0.3
            ).astype(jnp.float32)
    res = nuts_persistent_run_sharded(
        random.PRNGKey(41), t, init, mesh, step_size=0.4, num_samples=40,
        steps_per_sample=16, burn_in_steps=16, collect_chains_per_device=2,
        proposal_scheme="multinomial")
    assert res.samples.shape == (40, 16, 5)
    flat = np.asarray(res.samples).reshape(-1, 5)
    assert np.all(np.isfinite(flat))
    assert np.all(np.abs(flat.mean(0)) < 0.3)
    assert np.all(np.abs(flat.var(0) - 1.0) < 0.4)
    assert np.all(np.asarray(res.info["transitions"]) >= 1)


def test_warmup_mesh_dispatches_fused_sharded(monkeypatch):
    """Under a mesh, run_adaptive_warmup routes window scans through the
    shard_map runner with the FUSED GRAHMC kernel per device (VERDICT r2 #3:
    the GSPMD backend='xla' warmup fallback is gone), and learns a mass
    matrix statistically equivalent to the GSPMD path's."""
    import mcmc_tpu.tuning.adaptation as adapt
    import mcmc_tpu.ops.fused_trajectory as ft
    from mcmc_tpu.tuning import run_adaptive_warmup

    calls = {"sharded": 0, "fused": 0}
    orig_runner = adapt._make_sharded_window_runner
    orig_fused = ft.make_fused_grahmc_step

    def spy_runner(*a, **k):
        calls["sharded"] += 1
        return orig_runner(*a, **k)

    def spy_fused(*a, **k):
        calls["fused"] += 1
        return orig_fused(*a, **k)

    monkeypatch.setattr(adapt, "_make_sharded_window_runner", spy_runner)
    monkeypatch.setattr(ft, "make_fused_grahmc_step", spy_fused)

    t = standard_normal(4)
    mesh = make_mesh()
    init = shard_chains(random.normal(random.PRNGKey(30), (32, 4)) * 0.1, mesh)
    short = dict(exploration_steps=100, adaptation_windows=[100, 200],
                 cooldown_steps=25, max_iter_step=30,
                 gamma_samples_per_eval=10)

    step, inv_mass, pos, info = run_adaptive_warmup(
        "grahmc", t.log_prob_fn, None, init, random.PRNGKey(31),
        num_warmup=425, schedule_type="constant", num_steps=5,
        value_and_grad_fn=t.value_and_grad_fn, backend="interpret", mesh=mesh,
        **short)

    assert calls["sharded"] == 1, "mesh warmup must use the shard_map runner"
    assert calls["fused"] >= 1, "mesh warmup must build the fused kernel"
    assert step > 0 and np.isfinite(step)
    assert pos.shape == (32, 4)
    assert np.all(np.isfinite(np.asarray(inv_mass)))

    # GSPMD path (no mesh arg, XLA stepper over the sharded positions):
    # same estimator of the same posterior variance, so the learned metrics
    # agree statistically (RNG streams differ -> not bitwise).
    step_g, inv_mass_g, _, _ = run_adaptive_warmup(
        "grahmc", t.log_prob_fn, None, init, random.PRNGKey(31),
        num_warmup=425, schedule_type="constant", num_steps=5,
        value_and_grad_fn=t.value_and_grad_fn, backend="xla", **short)
    np.testing.assert_allclose(np.asarray(inv_mass), np.asarray(inv_mass_g),
                               atol=0.3)


def test_warmup_mesh_fused_nuts_windows(monkeypatch):
    """Persistent-NUTS warmup under a mesh traces its window step at the
    DEVICE-LOCAL chain width, i.e. runs the machine shard_mapped."""
    import mcmc_tpu.samplers.nuts_persistent as npz
    from mcmc_tpu.tuning import run_adaptive_warmup

    widths = []
    orig = npz._make_window_step

    def spy(*a, **k):
        step = orig(*a, **k)

        def traced(ps, xs):
            widths.append(ps.q.shape[0])
            return step(ps, xs)
        return traced

    monkeypatch.setattr(npz, "_make_window_step", spy)

    t = standard_normal(4)
    mesh = make_mesh()
    init = shard_chains(random.normal(random.PRNGKey(32), (32, 4)) * 0.1, mesh)

    step, inv_mass, pos, info = run_adaptive_warmup(
        "nuts", t.log_prob_fn, None, init, random.PRNGKey(33),
        num_warmup=175, value_and_grad_fn=t.value_and_grad_fn,
        backend="persistent", mesh=mesh,
        steps_per_warmup_step=8, exploration_steps=50,
        adaptation_windows=[100], cooldown_steps=25)

    assert widths and set(widths) == {32 // 8}, f"traced widths: {widths}"
    assert step > 0 and np.isfinite(step)
    assert pos.shape == (32, 4)
    assert np.all(np.isfinite(np.asarray(inv_mass)))


def test_sequential_tuner_sharded_fused_matches_unsharded():
    """GRAHMC friction tuning under a mesh runs its DA/ESJD probes
    shard_mapped through the fused kernel with pmean'd feedback, and lands
    on the same operating point as the unsharded XLA tuner (round 3: no
    XLA fallback remains anywhere in mesh warmup)."""
    from mcmc_tpu.tuning.sequential import sequential_tune_grahmc

    t = standard_normal(4)
    mesh = make_mesh()
    pos = random.normal(random.PRNGKey(40), (32, 4))
    kw = dict(num_steps=5, schedule_type="tanh", max_iter_step=50,
              gamma_samples_per_eval=20, gamma_coarse_values=(0.1, 1.0),
              value_and_grad_fn=t.value_and_grad_fn)

    step_s, gamma_s, steep_s, hist_s = sequential_tune_grahmc(
        random.PRNGKey(41), t.log_prob_fn, None, shard_chains(pos, mesh),
        backend="interpret", mesh=mesh, **kw)
    step_u, gamma_u, _, _ = sequential_tune_grahmc(
        random.PRNGKey(41), t.log_prob_fn, None, pos, backend="xla", **kw)

    assert np.isfinite(step_s) and step_s > 0
    assert gamma_s in (0.1, 1.0)
    # same selected gamma and a step within statistical agreement of the
    # unsharded tuner (RNG streams differ)
    assert gamma_s == gamma_u
    assert abs(np.log(step_s / step_u)) < 1.0
    assert len(hist_s["per_gamma_step"]) == 2


@pytest.mark.parametrize("group", ["shard_map", "gspmd", "diagnostics",
                                   "smc"])
def test_mesh_parity_checks(group):
    """The multi-device parity checks chip_smoke.py --multi runs on four
    GPUs (mcmc_tpu/parallel/parity.py), here on the 8-device CPU mesh with
    the kernel under the interpreter: every mesh path reproduces its
    one-device run."""
    from mcmc_tpu.parallel import parity
    from mcmc_tpu.targets import neals_funnel

    mesh = make_mesh()
    target = neals_funnel(6)
    init = target.init_sampler(random.PRNGKey(0), 32).astype(jnp.float32)
    if group == "shard_map":
        records = parity.shard_map_parity(mesh, target,
                                          shard_chains(init, mesh),
                                          backend="interpret")
        assert {r["check"] for r in records} >= {
            "shard_map/grahmc-kernel", "shard_map/persistent-nuts",
            "shard_map/persistent-nuts-multinomial",
            "shard_map/persistent-nuts-dense", "shard_map/tempering"}
        # same local shapes + same folded key: bitwise on one backend
        assert all(r["bitwise"] for r in records), records
    elif group == "gspmd":
        records = parity.gspmd_parity(mesh, target, init)
    elif group == "diagnostics":
        records = parity.diagnostics_parity(mesh, 32, 6)
    else:
        from mcmc_tpu.targets import standard_normal
        # 3x the largest log-Z gap over 20 seeds at 8 devices, 6D, 512
        # particles (0.222)
        records = parity.smc_parity(mesh, standard_normal(6), 512,
                                    move_backend="interpret", bound=0.67)
        assert records[0]["same_ladder"]
    assert records and all(r["ok"] for r in records), records


def test_sharded_nuts_counters_follow_global_slot_total():
    """The sharded persistent-NUTS totals take their dtype from the GLOBAL
    slot total: 1024 chains x 10k snapshots x 512 steps is 5.24e9 slots
    (past uint32) although each of the 8 shards holds only 6.6e8, so the
    psum'd counters must be float32, not a wrapping uint32. Trace-only
    (eval_shape) with x64 off, as on the accelerator."""
    from mcmc_tpu.parallel.fused_sharded import nuts_persistent_run_sharded

    t = standard_normal(4)
    mesh = make_mesh()

    def shapes(num_samples, steps_per_sample):
        return jax.eval_shape(
            lambda key, pos: nuts_persistent_run_sharded(
                key, t, pos, mesh, step_size=0.5, num_samples=num_samples,
                steps_per_sample=steps_per_sample,
                collect_chains_per_device=1),
            jax.ShapeDtypeStruct((2,), jnp.uint32),
            jax.ShapeDtypeStruct((1024, 4), jnp.float32))

    with jax.enable_x64(False):
        small = shapes(8, 16)
        big = shapes(10000, 512)
    assert small.info["n_leapfrog_slots"].dtype == jnp.uint32
    assert big.info["n_leapfrog_slots"].dtype == jnp.float32
    assert big.info["n_leapfrogs"].dtype == jnp.float32
