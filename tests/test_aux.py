"""Auxiliary subsystem tests: compat API, animations, tune-and-sample CLI."""

import numpy as np
import pytest
import jax.numpy as jnp
import jax.random as random

from mcmc_tpu.targets import standard_normal, gaussian_mixture, get_target


def test_compat_tuple_shapes_rwmh():
    from mcmc_tpu.compat import rwMH_run, rwMH_init
    t = standard_normal(4)
    init = random.normal(random.PRNGKey(0), (4, 4))
    samples, lps, acc, state = rwMH_run(random.PRNGKey(1), t.log_prob_fn,
                                        init, num_samples=50, scale=1.0,
                                        burn_in=10)
    assert samples.shape == (50, 4, 4)
    assert lps.shape == (50, 4)
    assert acc.shape == (4,)
    assert state.position.shape == (4, 4)


def test_compat_hmc_track_proposals_9tuple():
    from mcmc_tpu.compat import hmc_run
    t = standard_normal(4)
    init = random.normal(random.PRNGKey(2), (4, 4))
    out = hmc_run(random.PRNGKey(3), t.log_prob_fn, init, step_size=0.3,
                  num_steps=5, num_samples=20, track_proposals=True)
    assert len(out) == 9
    samples, lps, acc, state, pre_q, pre_lp, prop_q, prop_lp, dh = out
    assert prop_q.shape == (20, 4, 4)
    assert dh.shape == (20, 4)
    # ESJD plumbing: pre positions at step t+1 equal post positions at step t
    np.testing.assert_allclose(np.asarray(pre_q[1:]), np.asarray(samples[:-1]))


def test_compat_nuts_6tuple():
    from mcmc_tpu.compat import nuts_run
    t = standard_normal(3)
    init = random.normal(random.PRNGKey(4), (4, 3))
    out = nuts_run(random.PRNGKey(5), t.log_prob_fn, init, step_size=0.5,
                   num_samples=20)
    assert len(out) == 6
    assert out[4].shape == (20, 4)  # tree_depths


def test_compat_rahmc_matches_native():
    from mcmc_tpu.compat import rahmc_run
    from mcmc_tpu.samplers import grahmc_run
    t = standard_normal(4)
    init = random.normal(random.PRNGKey(6), (4, 4))
    s1, _, _, _ = rahmc_run(random.PRNGKey(7), t.log_prob_fn, init,
                            step_size=0.3, num_steps=5, gamma=0.5,
                            steepness=1.0, num_samples=20)
    r = grahmc_run(random.PRNGKey(7), t.log_prob_fn, init, step_size=0.3,
                   num_steps=5, gamma=0.5, steepness=1.0, num_samples=20)
    np.testing.assert_allclose(np.asarray(s1), np.asarray(r.samples))


def test_hmc_trace_conserves_energy():
    from mcmc_tpu.animations import hmc_proposal_trace
    t = standard_normal(2)
    tr = hmc_proposal_trace(random.PRNGKey(8), t.log_prob_fn,
                            jnp.array([0.3, -0.7]), 0.05, 30,
                            t.value_and_grad_fn)
    assert tr["positions"].shape == (31, 2)
    H = tr["hamiltonian"]
    assert abs(H[-1] - H[0]) < 0.01  # symplectic: tiny drift at eps=0.05


def test_grahmc_trace_dissipates_then_pumps():
    """Constant-schedule friction: H should NOT be conserved (by design)."""
    from mcmc_tpu.animations import rahmc_proposal_trace
    t = standard_normal(2)
    tr = rahmc_proposal_trace(random.PRNGKey(9), t.log_prob_fn,
                              jnp.array([0.3, -0.7]), 0.05, 30, gamma=2.0,
                              schedule_type="constant",
                              value_and_grad_fn=t.value_and_grad_fn)
    H = tr["hamiltonian"]
    assert np.all(np.isfinite(H))
    assert abs(H[15] - H[0]) > 0.05  # repelling phase pumps energy


@pytest.mark.slow
def test_tune_and_sample_rwmh_runs():
    from mcmc_tpu.tuning.core import tune_and_sample_rwmh
    t = get_target("standard_normal", dim=3)
    r = tune_and_sample_rwmh(random.PRNGKey(10), t, n_chains=8,
                             target_ess=200, batch_size=500,
                             max_samples=4000, warmup_steps=150)
    assert r["total_samples"] <= 4000
    assert r["diagnostics"]["ess_bulk_min"] > 0
    assert 0.05 < r["mean_acceptance"] < 0.6


@pytest.mark.slow
def test_tune_and_sample_grahmc_grid_runs():
    from mcmc_tpu.tuning.core import tune_and_sample_grahmc_grid
    t = get_target("standard_normal", dim=3)
    r = tune_and_sample_grahmc_grid(
        random.PRNGKey(11), t, n_chains=8, target_ess=150, batch_size=400,
        max_samples=800, warmup_steps=200, num_steps_grid=[4, 8],
        schedule_type="tanh")
    assert r["best_config"]["num_steps"] in (4, 8)
    assert len(r["grid_results"]) == 2
    assert all("gamma" in g for g in r["grid_results"])


@pytest.mark.slow
def test_track_convergence_path():
    """--track-convergence: log-spaced checkpoints with W2/ESS/R-hat traces."""
    from mcmc_tpu.benchmark import run_single_benchmark_with_L
    t = get_target("standard_normal", dim=3)
    r = run_single_benchmark_with_L(
        "hmc", t, "standard_normal", random.PRNGKey(30), n_chains=4,
        num_warmup=200, num_samples=400, schedule_type="constant",
        num_steps=8, track_convergence=True, convergence_base=1.5)
    assert r.get("error") is None
    trace = r["convergence_trace"]
    assert trace is not None and len(trace) >= 3
    assert trace[-1]["checkpoint"] == 400
    for cp in trace:
        assert set(cp) == {"checkpoint", "n_gradients", "w2_distance",
                           "ess_bulk_min", "ess_tail_min", "rhat_max"}
        assert cp["w2_distance"] is not None
    # W2 should tighten (or at least not blow up) as samples accumulate
    assert trace[-1]["w2_distance"] < trace[0]["w2_distance"] * 3


def test_profiling_utils():
    from mcmc_tpu.utils import wall_timer, device_trace, throughput_counters
    import time as _time
    with wall_timer() as t:
        _time.sleep(0.05)
    assert t.elapsed >= 0.05
    with device_trace(None):   # no-op path
        pass
    c = throughput_counters(num_samples=100, n_chains=8, num_steps=16,
                            sample_time=2.0, ess_bulk_min=400.0, n_devices=4)
    assert c["chain_steps_per_sec"] == 400.0
    assert c["grad_evals_per_sec"] == 6400.0
    assert c["ess_per_sec_per_chip"] == 50.0


def test_overlay_animation_renders(tmp_path):
    """animation_alt parity: single-axes overlay with repel/attract phase
    split renders and saves (reference animations/animation_alt.py:299-385)."""
    from mcmc_tpu.animations import animate_overlay_comparison
    out = str(tmp_path / "overlay.gif")
    fig, anim = animate_overlay_comparison(num_steps=8, output_path=out)
    import os
    assert os.path.getsize(out) > 1000


def test_enable_compilation_cache_policy(monkeypatch):
    """Set-to-empty disables; unset falls back to the default dir, which is
    the checkout's own .jax_cache."""
    import os

    import jax
    from mcmc_tpu.utils import enable_compilation_cache
    from mcmc_tpu.utils.profiling import DEFAULT_CACHE_DIR

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert DEFAULT_CACHE_DIR == os.path.join(repo, ".jax_cache")

    orig = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/tmp/somewhere")
        enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == "/tmp/somewhere"

        # set-to-empty must disable even when a cache was already enabled
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
        enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir is None

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        enable_compilation_cache(default_dir="/tmp/mcmc_default")
        assert jax.config.jax_compilation_cache_dir == "/tmp/mcmc_default"
        enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == DEFAULT_CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", orig)


def test_tuning_plot_param_label_and_errors(tmp_path):
    """DA histories carry the trace under BOTH scale_history and
    step_size_history; the label must follow the sampler, and missing /
    scalar-only histories raise ValueError, not TypeError (review findings)."""
    from mcmc_tpu.tuning import plots as tplots

    h = {"scale_history": [0.1, 0.2], "step_size_history": [0.1, 0.2],
         "accept_history": [0.5, 0.6], "converged_iter": 2,
         "target_accept": 0.65}
    tplots.plot_tuning_history(h, "HMC", output_file=str(tmp_path / "a.png"))
    tplots.plot_tuning_history(h, "RWMH", output_file=str(tmp_path / "b.png"))
    tplots.plot_coordinate_tuning_history(h, output_file=str(tmp_path / "c.png"))
    assert (tmp_path / "c.png").exists()
    with pytest.raises(ValueError):
        tplots.plot_tuning_history({"accept_history": [1]},
                                   output_file=str(tmp_path / "d.png"))
    with pytest.raises(ValueError):
        tplots.plot_coordinate_tuning_history({"converged_iter": 3},
                                              output_file=str(tmp_path / "e.png"))


def test_winner_heatmap_distinguishes_schedules(tmp_path):
    """grahmc-tanh and grahmc-sine select different L on the same target;
    the heatmap must key cells by the schedule-qualified label instead of
    silently overwriting (review finding)."""
    from analysis.grid_analysis import plot_L_winner_distribution
    from analysis.utils import get_unique_sampler_labels

    runs = [{"sampler": "grahmc", "schedule": s, "target": "rosenbrock",
             "selected_L": L, "has_grid_search": True,
             "grid_results": [{"num_steps": 8}, {"num_steps": L}]}
            for s, L in [("tanh", 16), ("sine", 64)]]
    assert get_unique_sampler_labels(runs) == ["grahmc-sine", "grahmc-tanh"]
    plot_L_winner_distribution(runs, output_dir=str(tmp_path))
    assert (tmp_path / "L_winner_heatmap.png").exists()


def test_summary_table_markdown_without_tabulate(tmp_path):
    """summary_table.md is written by a tabulate-free formatter (the
    optional dependency is declared nowhere; review finding)."""
    from analysis.research_plots import generate_summary_table
    rows = [{"sampler": "hmc", "target": "t", "num_steps": 8,
             "ess_bulk_min": 100.0, "ess_per_gradient": None,
             "rhat_max": 1.001, "sliced_w2": float("nan"),
             "accept_rate": 0.8, "divergence_rate": 0.0, "usable": True,
             "quality_pass": True, "total_time": 1.0}]
    generate_summary_table(rows, str(tmp_path))
    md = (tmp_path / "summary_table.md").read_text()
    assert md.startswith("| sampler")
    assert "hmc" in md and "1.001" in md


@pytest.mark.slow
def test_chees_tuning_example_runs(tmp_path):
    """examples/chees_tuning.py end-to-end at a tiny budget: tunes, does
    jittered sampling, writes the adaptation-history plot, reports sane
    diagnostics. The subprocess pins the CPU platform via jax.config."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    driver = (
        "import sys; sys.argv = ['chees_tuning.py', '--num-warmup', '200',"
        f" '--num-samples', '200', '--chains', '32', '--dim', '6',"
        f" '--out', {str(tmp_path)!r}];"
        "import jax; jax.config.update('jax_platforms', 'cpu');"
        f"exec(open({str(repo / 'examples' / 'chees_tuning.py')!r}).read())")
    proc = subprocess.run(
        [sys.executable, "-c", driver],
        capture_output=True, text=True, timeout=420, cwd=str(repo))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "tuned: T=" in proc.stdout
    assert "R-hat max=" in proc.stdout
    assert (tmp_path / "chees_history.png").exists()


@pytest.mark.slow
def test_tempering_example_runs(tmp_path):
    """examples/tempering.py end-to-end at a tiny budget: plain HMC stays
    in the left mode, the tuned ladder crosses, the mode histogram is
    written. The subprocess pins the CPU platform via jax.config."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    driver = (
        "import sys; sys.argv = ['tempering.py', '--num-samples', '300',"
        f" '--chains', '16', '--dim', '4', '--n-temps', '5',"
        f" '--ladder-rounds', '6', '--out', {str(tmp_path)!r}];"
        "import jax; jax.config.update('jax_platforms', 'cpu');"
        f"exec(open({str(repo / 'examples' / 'tempering.py')!r}).read())")
    proc = subprocess.run(
        [sys.executable, "-c", driver],
        capture_output=True, text=True, timeout=420, cwd=str(repo))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert "swap acceptance per pair" in out
    # plain run reports a stuck left mode; tempered reports crossings
    import re
    plain_frac = float(re.search(
        r"right-mode fraction = ([0-9.]+) \(true 0\.5\)", out).group(1))
    temp_frac = float(re.search(
        r"right-mode fraction = ([0-9.]+), Var", out).group(1))
    assert plain_frac < 0.15, out
    assert 0.25 < temp_frac < 0.75, out
    assert (tmp_path / "tempering_modes.png").exists()


@pytest.mark.slow
def test_custom_model_example_runs():
    """examples/custom_model.py end-to-end at a tiny budget: a USER-written
    batched log-posterior (autodiff gradients, no TargetDistribution, no
    registry) through warmup -> persistent NUTS -> diagnostics, with truth
    recovery. Pins the bring-your-own-model API contract."""
    import re
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    driver = (
        "import sys; sys.argv = ['custom_model.py', '--chains', '16',"
        " '--num-warmup', '200', '--num-samples', '150',"
        " '--n-data', '200', '--n-features', '5'];"
        "import jax; jax.config.update('jax_platforms', 'cpu');"
        f"exec(open({str(repo / 'examples' / 'custom_model.py')!r}).read())")
    proc = subprocess.run(
        [sys.executable, "-c", driver],
        capture_output=True, text=True, timeout=420, cwd=str(repo))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    rhat = float(re.search(r"R-hat max=([0-9.]+)", out).group(1))
    assert rhat < 1.05, out
    covered = re.search(r"truth inside the 95% interval: (\d+)/(\d+)", out)
    assert int(covered.group(1)) >= int(covered.group(2)) - 1, out
    acc = float(re.search(r"posterior ([0-9.]+) vs truth-ceiling", out)
                .group(1))
    assert acc > 0.6, out


def test_evidence_example_runs(tmp_path):
    """examples/evidence.py end-to-end at a tiny budget: the analytic
    unnormalized-Gaussian evidence, the conjugate-model Bayes factor (SMC
    vs closed form), and the bimodal transport + ladder plot."""
    import re
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    driver = (
        "import sys; sys.argv = ['evidence.py', '--particles', '512',"
        f" '--out', {str(tmp_path)!r}];"
        "import jax; jax.config.update('jax_platforms', 'cpu');"
        f"exec(open({str(repo / 'examples' / 'evidence.py')!r}).read())")
    proc = subprocess.run(
        [sys.executable, "-c", driver],
        capture_output=True, text=True, timeout=420, cwd=str(repo))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    smc_z = float(re.search(
        r"SMC log Z = ([+-][0-9.]+) \(error", out).group(1))
    true_z = float(re.search(r"true log Z = ([0-9.+-]+)", out).group(1))
    assert abs(smc_z - true_z) < 0.6, out
    bf = re.search(r"log Bayes factor \(well vs tight\): SMC ([+-][0-9.]+) "
                   r"vs exact ([+-][0-9.]+)", out)
    assert abs(float(bf.group(1)) - float(bf.group(2))) < 2.0, out
    frac = float(re.search(r"right-mode fraction = ([0-9.]+) "
                           r"\(true 0\.5\)", out).group(1))
    assert 0.25 < frac < 0.75, out
    assert (tmp_path / "evidence_smc.png").exists()
