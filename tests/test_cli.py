"""CLI + result-schema tests: runner schema parity, resume, analysis package."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax.random as random

from mcmc_tpu.benchmark import (
    get_log_checkpoints, run_single_benchmark_with_L, save_result_incremental,
    run_all_benchmarks,
)
from mcmc_tpu.targets import get_target

# Result fields the reference emits for every successful run
# (reference run_benchmarks.py:831-888)
SCHEMA_FIELDS = [
    "sampler", "target", "schedule", "dim", "num_steps", "n_chains",
    "num_warmup", "num_samples", "total_samples", "warmup_time", "sample_time",
    "total_time", "accept_rate", "rhat_max", "rhat_mean", "ess_bulk_min",
    "ess_bulk_mean", "ess_tail_min", "ess_tail_mean", "ess_per_sample",
    "ess_per_gradient", "divergence_rate", "total_divergences", "n_gradients",
    "rhat_pass", "ess_pass", "ess_tail_pass", "stats_pass", "z_score_max",
    "z_score_threshold", "usable", "quality_pass", "is_inefficient",
    "is_high_efficiency", "sliced_w2", "convergence_trace",
    "mass_matrix_learned",
]


def test_log_checkpoints():
    cps = get_log_checkpoints(10000, base=1.5)
    assert cps[0] == 100
    assert cps[-1] == 10000
    assert all(b > a for a, b in zip(cps, cps[1:]))


def test_log_checkpoints_quantized():
    """quantum snaps interior checkpoints so all gaps but the last are
    multiples — one compiled batch program serves the whole tracked run."""
    from mcmc_tpu.benchmark.runner import _checkpoint_chunks
    cps = get_log_checkpoints(10000, base=1.5, quantum=50)
    assert cps[-1] == 10000
    assert all(b > a for a, b in zip(cps, cps[1:]))
    gaps = [b - a for a, b in zip([0] + cps, cps)]
    assert all(g % 50 == 0 for g in gaps[:-1])
    # chunking: interior batches split into exact quantum widths; a final
    # remainder (if any) is the only second width
    widths = {w for g in gaps for w in _checkpoint_chunks(g, 50)}
    assert len(widths - {50}) <= 1
    assert sum(sum(_checkpoint_chunks(g, 50)) for g in gaps) == 10000
    # tiny budgets: last checkpoint preserved, no empty/duplicate interior
    assert get_log_checkpoints(120, base=1.5, quantum=30)[-1] == 120
    assert _checkpoint_chunks(0, 50) == []
    assert _checkpoint_chunks(70, 50) == [50, 20]
    assert _checkpoint_chunks(70, 1) == [70]


@pytest.mark.slow
def test_single_benchmark_schema_rwmh():
    t = get_target("standard_normal", dim=4)
    r = run_single_benchmark_with_L(
        "rwmh", t, "standard_normal", random.PRNGKey(0), n_chains=4,
        num_warmup=100, num_samples=300, schedule_type="constant", num_steps=20)
    assert r.get("error") is None
    for f in SCHEMA_FIELDS:
        assert f in r, f"missing field {f}"
    assert r["scale"] > 0           # rwmh metadata
    assert r["n_gradients"] == 0
    assert r["num_steps"] is None   # rwmh has no trajectory length


@pytest.mark.slow
def test_single_benchmark_schema_nuts():
    t = get_target("standard_normal", dim=4)
    r = run_single_benchmark_with_L(
        "nuts", t, "standard_normal", random.PRNGKey(1), n_chains=4,
        num_warmup=300, num_samples=400, schedule_type="constant", num_steps=20)
    assert r.get("error") is None
    assert r["max_tree_depth"] == 10
    assert r["avg_tree_depth"] > 0
    assert r["n_gradients"] > 0
    assert isinstance(r["divergence_rate"], float)  # real, not placeholder


def test_incremental_save_and_column_pinning(tmp_path):
    r1 = {"sampler": "hmc", "target": "T", "usable": True, "extra_a": 1.23456}
    r2 = {"sampler": "nuts", "target": "T", "usable": False, "extra_b": 7}
    save_result_incremental(r1, str(tmp_path), is_first=True)
    save_result_incremental(r2, str(tmp_path), is_first=False)

    results = json.loads((tmp_path / "benchmark_results.json").read_text())
    assert len(results) == 2
    assert results[0]["extra_a"] == 1.2346  # rounded to 4 decimals
    cols = json.loads((tmp_path / ".csv_columns.json").read_text())
    assert cols == ["sampler", "target", "usable", "extra_a"]
    csv_lines = (tmp_path / "benchmark_results.csv").read_text().strip().splitlines()
    assert len(csv_lines) == 3  # header + 2 rows


def test_csv_rows_follow_pinned_columns(tmp_path):
    """The stdlib CSV writer keeps the pinned column order across appends:
    later keys outside it are dropped, missing ones and None/NaN are empty,
    bools and numbers are written as str() writes them."""
    import csv
    r1 = {"sampler": "hmc", "target": "T", "usable": True, "rhat_max": None,
          "ess": float("nan"), "n": 3}
    r2 = {"target": "U", "sampler": "nuts", "extra": 7, "n": 2.5}
    save_result_incremental(r1, str(tmp_path), is_first=True)
    save_result_incremental(r2, str(tmp_path), is_first=False)
    with open(tmp_path / "benchmark_results.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["sampler", "target", "usable", "rhat_max", "ess", "n"]
    assert rows[1] == ["hmc", "T", "True", "", "", "3"]
    assert rows[2] == ["nuts", "U", "", "", "", "2.5"]


def test_csv_nested_fields_written_as_json(tmp_path):
    """grid_search_info / convergence_trace go into the CSV as JSON text
    (the JSON file keeps them as objects)."""
    import csv
    info = {"best_L": 8, "all_results": [{"num_steps": 8, "usable": True}]}
    save_result_incremental({"sampler": "hmc", "grid_search_info": info,
                             "convergence_trace": None}, str(tmp_path),
                            is_first=True)
    with open(tmp_path / "benchmark_results.csv", newline="") as f:
        header, row = list(csv.reader(f))
    cell = dict(zip(header, row))
    assert json.loads(cell["grid_search_info"]) == info
    assert cell["convergence_trace"] == ""
    saved = json.loads((tmp_path / "benchmark_results.json").read_text())
    assert saved[0]["grid_search_info"] == info


def test_print_summary_on_result_rows(capsys):
    """print_summary works on the list of row dicts run_all_benchmarks
    returns: pass/usable counts, grid failures, efficiency ranking."""
    from mcmc_tpu.benchmark import print_summary
    rows = [
        {"sampler": "hmc", "target": "T", "schedule": None,
         "quality_pass": True, "usable": True, "ess_per_gradient": 0.1,
         "ess_bulk_min": 500.0, "rhat_max": 1.001},
        {"sampler": "grahmc", "target": "T", "schedule": "tanh",
         "quality_pass": False, "usable": True, "ess_per_gradient": 0.2,
         "ess_bulk_min": 900.0, "rhat_max": None},
        {"sampler": "nuts", "target": "U", "quality_pass": False,
         "usable": False, "grid_search_failed": True, "num_steps": 8},
    ]
    print_summary(rows)
    out = capsys.readouterr().out
    assert "High quality: 1/3" in out and "Usable: 2/3" in out
    assert "GRID FAILURE: nuts on U" in out
    top = out[out.index("Top 10"):]
    assert top.index("grahmc-tanh") < top.index("hmc ")
    assert "R-hat=n/a" in top
    print_summary([])
    assert "No results." in capsys.readouterr().out


def test_incremental_save_replaces_stale_config_row(tmp_path):
    """Re-measuring a config under new run-level settings (e.g. a dense
    NUTS row whose backend resolution changed) must REPLACE its stale row
    in the canonical JSON, not double-count it in downstream summaries."""
    stale = {"sampler": "nuts", "target": "funnel", "schedule": None,
             "mass_matrix_learned": "dense", "nuts_backend": "classic",
             "min_ess": 1.0}
    other = {"sampler": "hmc", "target": "funnel", "schedule": None,
             "mass_matrix_learned": "dense", "min_ess": 2.0}
    fresh = {"sampler": "nuts", "target": "funnel", "schedule": None,
             "mass_matrix_learned": "dense", "nuts_backend": "persistent",
             "min_ess": 3.0}
    save_result_incremental(stale, str(tmp_path), is_first=True)
    save_result_incremental(other, str(tmp_path), is_first=False)
    save_result_incremental(fresh, str(tmp_path), is_first=False)

    results = json.loads((tmp_path / "benchmark_results.json").read_text())
    assert len(results) == 2
    by_sampler = {r["sampler"]: r for r in results}
    assert by_sampler["nuts"]["nuts_backend"] == "persistent"
    assert by_sampler["nuts"]["min_ess"] == 3.0
    assert by_sampler["hmc"]["min_ess"] == 2.0


@pytest.mark.slow
def test_run_all_benchmarks_resume(tmp_path):
    """Second invocation must skip the completed signature."""
    kw = dict(samplers=["rwmh"], targets=["standard_normal"],
              grahmc_schedules=["constant"], dim=3, n_chains=4, num_warmup=100,
              num_samples=200, seed=0, output_dir=str(tmp_path))
    df1 = run_all_benchmarks(**kw)
    assert len(df1) == 1
    df2 = run_all_benchmarks(**kw)   # resume: nothing new
    assert len(df2) == 1
    results = json.loads((tmp_path / "benchmark_results.json").read_text())
    assert len(results) == 1


# ----------------------------------------------------------------------------
# Analysis package on synthetic results
# ----------------------------------------------------------------------------

def _fake_results():
    def run(sampler, target, L, schedule=None, ess_pg=0.01, usable=True,
            quality=True):
        grid = [{"num_steps": l, "ess_per_gradient": ess_pg * (1 + 0.1 * i),
                 "ess_bulk_min": 500, "ess_tail_min": 300, "rhat_max": 1.003,
                 "rhat_mean": 1.001, "accept_rate": 0.7, "step_size": 0.3,
                 "total_samples": 1000, "n_gradients": 1000 * l,
                 "warmup_time": 1.0, "sample_time": 2.0, "usable": True,
                 "quality_pass": True, "divergence_rate": 0.0,
                 "sliced_w2": 0.05, "z_score_max": 1.0, "gamma": 0.5,
                 "steepness": 2.0}
                for i, l in enumerate([8, 16, L])]
        return {
            "sampler": sampler, "target": target, "schedule": schedule,
            "dim": 10, "num_steps": L, "ess_bulk_min": 500.0,
            "ess_tail_min": 300.0, "ess_per_gradient": ess_pg,
            "rhat_max": 1.003, "sliced_w2": 0.05, "accept_rate": 0.7,
            "divergence_rate": 0.0, "usable": usable, "quality_pass": quality,
            "gamma": 0.5 if schedule else None, "total_time": 10.0,
            "grid_search_info": {"tested_L_values": [8, 16, L],
                                 "selected_L": L,
                                 "selection_tier": "quality_pass",
                                 "has_usable": True, "all_results": grid},
        }
    return [
        run("hmc", "StandardNormal10D", 24, ess_pg=0.02),
        run("grahmc", "StandardNormal10D", 32, "tanh", ess_pg=0.03),
        run("grahmc", "StandardNormal10D", 16, "constant", ess_pg=0.01),
        run("nuts", "NealsFunnel10D", 8, ess_pg=0.05),
    ]


def test_analysis_package_end_to_end(tmp_path):
    results_dir = tmp_path / "results"
    results_dir.mkdir()
    (results_dir / "benchmark_results.json").write_text(
        json.dumps(_fake_results()))

    from analysis.utils import load_benchmark_results, summarize_results
    rs = load_benchmark_results(str(results_dir))
    assert all(r["has_grid_search"] for r in rs)
    assert rs[0]["selected_L"] == 24
    s = summarize_results(rs)
    assert s["total_runs"] == 4 and s["usable_runs"] == 4
    assert s["schedules"] == ["constant", "tanh"]

    out = tmp_path / "plots"
    from analysis.grid_analysis import (
        plot_L_selection_analysis, plot_L_winner_distribution,
        analyze_L_grid_coverage)
    plot_L_selection_analysis(rs, str(out))
    plot_L_winner_distribution(rs, str(out))
    cov = analyze_L_grid_coverage(rs)
    assert cov["n_runs"] == 4

    from analysis.research_plots import (
        plot_sampler_comparison, plot_schedule_comparison,
        plot_efficiency_quality_tradeoff, generate_winner_matrix,
        generate_summary_table)
    plot_sampler_comparison(rs, str(out))
    plot_schedule_comparison(rs, str(out))
    plot_efficiency_quality_tradeoff(rs, str(out))
    generate_winner_matrix(rs, str(out))
    generate_summary_table(rs, str(out))

    produced = {p.name for p in out.iterdir()}
    assert {"L_winner_distribution.png", "L_winner_heatmap.png",
            "sampler_comparison.png", "schedule_comparison.png",
            "efficiency_quality_tradeoff.png", "winner_matrix.png",
            "summary_table.csv", "summary_table.md"} <= produced


def test_analyze_cli_requires_action(tmp_path):
    """CLI errors out when no analysis option given (reference parity)."""
    proc = subprocess.run(
        [sys.executable, "analyze_benchmarks.py", str(tmp_path)],
        capture_output=True, text=True, cwd=os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    assert proc.returncode != 0
    assert "At least one analysis option" in proc.stderr


def test_round_floats_preserves_ints():
    """np.integer values serialize as ints (reference writes them as ints);
    np.floating rounds like python floats — VERDICT r1 weak #6."""
    from mcmc_tpu.benchmark.runner import _round_floats
    out = _round_floats({"n": np.int64(7), "x": np.float64(1.23456789),
                         "y": 2.3456789, "b": np.bool_(True), "s": "k"})
    assert out["n"] == 7 and isinstance(out["n"], int)
    assert out["x"] == 1.2346 and isinstance(out["x"], float)
    assert out["y"] == 2.3457 and out["b"] is True and out["s"] == "k"


@pytest.mark.slow
def test_single_benchmark_mesh_sharded_e2e():
    """8-device CPU-mesh e2e: GSPMD chain sharding through the full
    warmup+sample+gate pipeline produces a schema-valid result row
    (VERDICT r1 item 5)."""
    t = get_target("standard_normal", dim=4)
    r = run_single_benchmark_with_L(
        "grahmc", t, "standard_normal", random.PRNGKey(3), n_chains=16,
        num_warmup=150, num_samples=300, schedule_type="tanh", num_steps=8,
        mesh_devices=8)
    assert r.get("error") is None
    for f in SCHEMA_FIELDS:
        assert f in r, f"missing field {f}"
    assert r["n_chains"] == 16
    assert 0.0 < r["accept_rate"] <= 1.0
    assert np.isfinite(r["rhat_max"])


def test_sample_dispatches_to_sharded_fused_kernel():
    """With a mesh and a kernel backend ('interpret' here: the kernel under
    the interpreter), _sample routes to the shard_map fused-kernel wrapper
    (grahmc_run_sharded) and returns a full-chain history with real
    divergence totals."""
    from mcmc_tpu.benchmark.runner import _sample
    from mcmc_tpu.parallel import make_mesh

    t = get_target("standard_normal", dim=4)
    mesh = make_mesh(8)
    pos = random.normal(random.PRNGKey(4), (32, 4)).astype(np.float32)
    res = _sample("grahmc", t, random.PRNGKey(5), pos, step_size=0.4,
                  num_steps=6, num_samples=50, inv_mass=None,
                  schedule_type="tanh", warmup_info={"gamma": 0.5,
                                                     "steepness": 1.0},
                  backend="interpret", mesh=mesh)
    assert res.samples.shape == (50, 32, 4)
    assert res.final_state.position.shape == (32, 4)
    assert "total_divergences" in res.info
    assert res.info["n_devices"] == 8
    assert 0.0 < float(res.accept_rate.mean()) <= 1.0


def test_sample_dispatches_hmc_to_sharded_fused_kernel():
    """HMC on the sharded fused path runs friction-free (gamma=0)."""
    from mcmc_tpu.benchmark.runner import _sample
    from mcmc_tpu.parallel import make_mesh

    t = get_target("standard_normal", dim=4)
    mesh = make_mesh(4)
    pos = random.normal(random.PRNGKey(6), (16, 4)).astype(np.float32)
    res = _sample("hmc", t, random.PRNGKey(7), pos, step_size=0.4,
                  num_steps=6, num_samples=40, inv_mass=None,
                  schedule_type="constant", warmup_info={},
                  backend="interpret", mesh=mesh)
    assert res.samples.shape == (40, 16, 4)
    assert np.all(np.isfinite(np.asarray(res.samples)))


@pytest.mark.slow
def test_single_benchmark_nuts_persistent_backend():
    """--nuts-backend persistent: schema-valid row, exact leapfrog-count
    gradient accounting."""
    t = get_target("standard_normal", dim=4)
    r = run_single_benchmark_with_L(
        "nuts", t, "standard_normal", random.PRNGKey(11), n_chains=8,
        num_warmup=200, num_samples=300, schedule_type="constant",
        num_steps=20, nuts_backend="persistent")
    assert r.get("error") is None
    for f in SCHEMA_FIELDS:
        assert f in r, f"missing field {f}"
    # n_gradients = leapfrogs actually executed: the XLA machine executes
    # every slot (== 300*64*8).
    slots = 300 * 64 * 8
    assert 0 < r["n_gradients"] <= slots
    assert r["avg_tree_depth"] is not None


def test_nuts_backend_auto_resolution(monkeypatch):
    """'auto' (the CLI default) pins dispatch to classic on every platform
    until a GPU cell decides the rule (ROADMAP); explicit values pass
    through unchanged. The trajectory backend of HMC/GRAHMC rows follows
    the shared resolver: the kernel only on a GPU, RWMH always XLA."""
    import jax
    import mcmc_tpu.benchmark.runner as runner_mod

    t = get_target("standard_normal", dim=4)
    assert getattr(t.value_and_grad_fn, "pallas_info", None) is not None
    t_plain = t._replace(
        value_and_grad_fn=lambda q: t.value_and_grad_fn(q))

    for platform in ("cpu", "gpu"):
        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        assert runner_mod._resolve_nuts_backend("auto", t) == "classic"
        assert runner_mod._resolve_backend("rwmh", t) == "xla"
        assert runner_mod._resolve_backend("hmc", t_plain) == "xla"
    assert runner_mod._resolve_backend("grahmc", t) == "pallas"   # gpu
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert runner_mod._resolve_backend("grahmc", t) == "xla"

    # explicit values are honored as given (the opt-out)
    assert runner_mod._resolve_nuts_backend("classic", t) == "classic"
    assert runner_mod._resolve_nuts_backend("persistent", t_plain) == "persistent"


def test_grid_summary_carries_mass_matrix_stats():
    """Grid all_results entries keep the learned-metric stats so failed
    arms (usually a bad per-L warmup metric) can be post-mortemed."""
    from mcmc_tpu.benchmark.runner import _grid_summary
    r = {"num_steps": 16, "ess_per_gradient": 0.1, "mass_matrix_min": 0.5,
         "mass_matrix_max": 9.1, "mass_matrix_mean": 1.2, "rhat_max": 1.01}
    s = _grid_summary(r)
    assert s["mass_matrix_min"] == 0.5
    assert s["mass_matrix_max"] == 9.1
    assert s["mass_matrix_mean"] == 1.2


@pytest.mark.slow
def test_reparameterized_target_reports_transformed_w2():
    """Targets with transform/transform_target also report W2 of the
    TRANSFORMED draws against the transform target's ground truth
    (non-centered funnel -> centered-funnel coordinates)."""
    t = get_target("neals_funnel_noncentered", dim=4)
    r = run_single_benchmark_with_L(
        "rwmh", t, "neals_funnel_noncentered", random.PRNGKey(21),
        n_chains=4, num_warmup=100, num_samples=300,
        schedule_type="constant", num_steps=20)
    assert r.get("error") is None
    assert r["sliced_w2"] is not None
    assert r["sliced_w2_transformed"] is not None
    assert np.isfinite(r["sliced_w2_transformed"])
    # targets without a transform leave the field None
    t2 = get_target("standard_normal", dim=4)
    r2 = run_single_benchmark_with_L(
        "rwmh", t2, "standard_normal", random.PRNGKey(22), n_chains=4,
        num_warmup=100, num_samples=300, schedule_type="constant",
        num_steps=20)
    assert r2["sliced_w2_transformed"] is None


@pytest.mark.slow
def test_nuts_steps_per_sample_flag_threads_to_persistent_path():
    """--nuts-steps-per-sample controls the persistent snapshot interval;
    the result row records it and executed leapfrogs stay within the slot
    budget implied by the interval."""
    t = get_target("standard_normal", dim=4)
    r = run_single_benchmark_with_L(
        "nuts", t, "standard_normal", random.PRNGKey(31), n_chains=8,
        num_warmup=200, num_samples=200, schedule_type="constant",
        num_steps=20, nuts_backend="persistent", nuts_steps_per_sample=16)
    assert r.get("error") is None
    assert r["nuts_steps_per_sample"] == 16
    assert 0 < r["n_gradients"] <= 200 * 16 * 8


@pytest.mark.slow
def test_nuts_proposal_flag_threads_to_persistent_path():
    """--nuts-proposal multinomial routes the persistent sampling phase
    through the Stan-scheme XLA machine and the row records the scheme.

    slow: the cost is TRACING the warmup + sampling multinomial machines
    on a single CPU core (~6 min even at tiny draw budgets); the scheme's
    statistical correctness is pinned by test_nuts_persistent.py, and the fast tier
    keeps the pure-Python resume-key routing check below."""
    t = get_target("standard_normal", dim=4)
    r = run_single_benchmark_with_L(
        "nuts", t, "standard_normal", random.PRNGKey(31), n_chains=8,
        num_warmup=60, num_samples=50, schedule_type="constant",
        num_steps=20, nuts_backend="persistent",
        nuts_steps_per_sample=16, nuts_proposal="multinomial")
    assert r.get("error") is None
    assert r["nuts_proposal"] == "multinomial"
    assert 0 < r["n_gradients"] <= 50 * 16 * 8


def test_resume_signature_keys_nuts_proposal():
    """Resume keys distinguish the NUTS proposal scheme (pre-multinomial
    rows == endpoint), so re-running a grid with --nuts-proposal
    multinomial re-measures instead of [SKIP]ping stale endpoint rows."""
    from mcmc_tpu.benchmark.runner import _resume_signature
    assert (_resume_signature("nuts", "T", None, True, "persistent", 64,
                              nuts_proposal="multinomial")
            != _resume_signature("nuts", "T", None, True, "persistent", 64))
    assert (_resume_signature("nuts", "T", None, True, "persistent", 64,
                              nuts_proposal="endpoint")
            == _resume_signature("nuts", "T", None, True, "persistent", 64))


def test_resume_signature_keys_nuts_settings():
    """Resume keys must distinguish NUTS backend/interval (review finding).

    Re-running a grid with a different --nuts-steps-per-sample or
    --nuts-backend must re-measure NUTS configs rather than print [SKIP]
    and keep rows measured under the old settings; non-NUTS signatures are
    unchanged by the extra fields.
    """
    from mcmc_tpu.benchmark.runner import _resume_signature

    base = _resume_signature("nuts", "neals_funnel", None, True,
                             "persistent", 64)
    assert base != _resume_signature("nuts", "neals_funnel", None, True,
                                     "persistent", 16)
    assert base != _resume_signature("nuts", "neals_funnel", None, True,
                                     "classic", None)
    # classic ignores the interval: same key whatever the flag value
    assert (_resume_signature("nuts", "T", None, True, "classic", 64)
            == _resume_signature("nuts", "T", None, True, "classic", 16))
    # pre-upgrade rows (fields missing) never collide with resolved runs
    assert (_resume_signature("nuts", "T", None, True, None, None)
            != _resume_signature("nuts", "T", None, True, "persistent", 64))
    # non-NUTS rows: extra fields are ignored entirely
    assert (_resume_signature("grahmc", "T", "tanh", True)
            == _resume_signature("grahmc", "T", "tanh", True, "x", 1))


def test_single_benchmark_tempered_e2e():
    """--tempering K=3 through the full pipeline: schema-valid row carrying
    the ladder metadata, gradient accounting charged for all K replicas."""
    t = get_target("standard_normal", dim=4)
    r = run_single_benchmark_with_L(
        "hmc", t, "standard_normal", random.PRNGKey(9), n_chains=16,
        num_warmup=150, num_samples=300, schedule_type="constant",
        num_steps=8, mesh_devices="off", tempering=3)
    assert r.get("error") is None
    for f in SCHEMA_FIELDS:
        assert f in r, f"missing field {f}"
    assert r["tempering"] == 3
    assert len(r["swap_accept_rate"]) == 2
    assert len(r["replica_accept_rate"]) == 3
    assert len(r["tempering_betas"]) == 3
    assert r["tempering_betas"][0] == 1.0
    # all K replicas' leapfrogs are charged
    assert r["n_gradients"] == 300 * 8 * 16 * 3
    assert np.isfinite(r["rhat_max"])


def test_tempered_convergence_trace_accounting():
    """Checkpointed tempered runs: every convergence-trace entry charges
    the xK replica factor the headline n_gradients uses (they disagreed
    by K before — trace-based ESS/gradient plots overstated tempered
    efficiency), and the recorded ladder stats cover the WHOLE run, not
    the final checkpoint batch."""
    t = get_target("standard_normal", dim=3)
    r = run_single_benchmark_with_L(
        "hmc", t, "standard_normal", random.PRNGKey(2), n_chains=8,
        num_warmup=60, num_samples=120, schedule_type="constant",
        num_steps=4, mesh_devices="off", tempering=3,
        track_convergence=True)
    assert r.get("error") is None
    for e in r["convergence_trace"]:
        assert e["n_gradients"] == e["checkpoint"] * 4 * 8 * 3
    assert r["convergence_trace"][-1]["n_gradients"] == r["n_gradients"]
    assert len(r["swap_accept_rate"]) == 2
    assert all(0.0 <= a <= 1.0 for a in r["swap_accept_rate"])
    assert all(0.0 < a <= 1.0 for a in r["replica_accept_rate"])


def test_tempered_mesh_convergence_e2e():
    """--tempering composes with --mesh and --track-convergence: the ladder
    runs shard_mapped per checkpoint chunk with the full replica state
    threaded between chunks (not re-tiled from the cold rows).

    Was 24 min solo when every distinct checkpoint width compiled its own
    shard_map program AND each checkpoint paid a GSPMD-distributed W2 sort;
    quantized chunking + the unsharded ConvergenceW2Tracker brought it to
    ~107s (measured solo, 2026-08-19)."""
    t = get_target("standard_normal", dim=4)
    r = run_single_benchmark_with_L(
        "grahmc", t, "standard_normal", random.PRNGKey(11), n_chains=16,
        num_warmup=120, num_samples=250, schedule_type="tanh", num_steps=6,
        mesh_devices=8, tempering=3, track_convergence=True)
    assert r.get("error") is None
    assert r["tempering"] == 3
    assert r["mesh_devices"] == 8
    assert r["convergence_trace"] is not None
    assert len(r["convergence_trace"]) >= 2
    assert np.isfinite(r["rhat_max"])


def test_resume_signature_keys_tempering():
    """Re-running with a different --tempering must re-measure trajectory-
    sampler rows instead of skipping; NUTS/RWMH signatures ignore it."""
    from mcmc_tpu.benchmark.runner import _resume_signature

    base = _resume_signature("grahmc", "T", "tanh", True)
    assert base != _resume_signature("grahmc", "T", "tanh", True,
                                     tempering=4)
    assert (_resume_signature("grahmc", "T", "tanh", True, tempering=4)
            != _resume_signature("grahmc", "T", "tanh", True, tempering=6))
    # 0/1/None all mean "untempered" and share the pre-tempering key
    assert base == _resume_signature("grahmc", "T", "tanh", True, tempering=0)
    assert base == _resume_signature("grahmc", "T", "tanh", True, tempering=1)
    assert (_resume_signature("nuts", "T", None, True, "classic", None)
            == _resume_signature("nuts", "T", None, True, "classic", None,
                                 tempering=4))


def test_tempering_rejects_chees_combination():
    """--tempering + --trajectory-tuner chees is a configuration error."""
    from mcmc_tpu.benchmark.runner import run_all_benchmarks

    with pytest.raises(ValueError, match="tempering"):
        run_all_benchmarks(
            samplers=["grahmc"], targets=["standard_normal"],
            grahmc_schedules=["tanh"], dim=4, n_chains=8, num_warmup=50,
            num_samples=50, seed=0, output_dir="/tmp/never-written",
            trajectory_tuner="chees", tempering=4)


def test_nuts_steps_per_sample_flag_rejects_nonpositive():
    """--nuts-steps-per-sample 0 / negative must be an argparse error, not a
    zero-iteration persistent window emitting identical draws."""
    import subprocess
    import sys

    for bad in ("0", "-8"):
        proc = subprocess.run(
            [sys.executable, "run_benchmarks.py", "--nuts-steps-per-sample",
             bad, "--targets", "standard_normal", "--samplers", "nuts"],
            capture_output=True, text=True, timeout=120,
            cwd=str(Path(__file__).resolve().parent.parent))
        assert proc.returncode == 2, proc.stderr
        assert "positive integer" in proc.stderr


def test_resume_signature_keys_trajectory_tuner():
    """Re-running a results dir with a different --trajectory-tuner must
    re-measure HMC/GRAHMC configs rather than [SKIP]; grid rows (and all
    pre-chees rows, which were grid by construction) share one key."""
    from mcmc_tpu.benchmark.runner import _resume_signature

    grid = _resume_signature("grahmc", "T", "tanh", True)
    chees = _resume_signature("grahmc", "T", "tanh", True,
                              trajectory_tuner="chees")
    assert grid != chees
    assert grid == _resume_signature("grahmc", "T", "tanh", True,
                                     trajectory_tuner=None)
    # rwmh/nuts signatures ignore the tuner entirely
    assert (_resume_signature("rwmh", "T", None, False)
            == _resume_signature("rwmh", "T", None, False,
                                 trajectory_tuner="chees"))
    assert (_resume_signature("nuts", "T", None, True, "classic", None)
            == _resume_signature("nuts", "T", None, True, "classic", None,
                                 trajectory_tuner="chees"))


def test_chees_cap_fallback_annotates_and_resumes(tmp_path, monkeypatch):
    """When the ChEES warmup hits the trajectory cap the runner falls back
    to the L grid search; the fallback row must be saved under the CHEES
    resume signature (trajectory_tuner='chees') so a resumed chees grid
    does not re-pay the failed tuning attempt."""
    from mcmc_tpu.benchmark import runner as runner_mod

    calls = {"chees": 0, "grid": 0}

    def fake_single(*args, **kwargs):
        calls["chees"] += 1
        assert kwargs.get("trajectory_tuner") == "chees"
        return {"sampler": args[0], "target": args[1].name,
                "schedule": "constant", "mass_matrix_learned": True,
                "trajectory_tuner": "chees", "chees_cap_hit": True}

    def fake_grid(*args, **kwargs):
        calls["grid"] += 1
        return {"sampler": args[0], "target": args[1].name,
                "schedule": "constant", "mass_matrix_learned": True}

    monkeypatch.setattr(runner_mod, "run_single_benchmark_with_L", fake_single)
    monkeypatch.setattr(runner_mod, "run_trajectory_length_grid_search",
                        fake_grid)

    kw = dict(samplers=["grahmc"], targets=["log_gamma"],
              grahmc_schedules=["constant"], dim=3, n_chains=4,
              num_warmup=100, num_samples=100, seed=0,
              output_dir=str(tmp_path), trajectory_tuner="chees",
              warmup_cache=False)
    df1 = runner_mod.run_all_benchmarks(**kw)
    assert calls == {"chees": 1, "grid": 1}
    row = df1[0]
    assert row["trajectory_tuner"] == "chees"
    assert bool(row["chees_fell_back"]) is True
    assert all("chees_cap_hit" not in r for r in df1)  # abandoned row was discarded

    # resume: the fallback row satisfies the chees signature — no re-run
    runner_mod.run_all_benchmarks(**kw)
    assert calls == {"chees": 1, "grid": 1}

    # a grid re-run of the same dir is a DIFFERENT signature: re-measures
    runner_mod.run_all_benchmarks(**{**kw, "trajectory_tuner": "grid"})
    assert calls == {"chees": 1, "grid": 2}


@pytest.mark.slow
def test_run_all_benchmarks_chees_tuner_e2e(tmp_path):
    """--trajectory-tuner chees end-to-end: one warmup tunes T, sampling is
    jittered, the row records the tuner products, and n_gradients counts
    the realized leapfrogs."""
    kw = dict(samplers=["hmc"], targets=["standard_normal"],
              grahmc_schedules=["constant"], dim=3, n_chains=16,
              num_warmup=300, num_samples=200, seed=0,
              output_dir=str(tmp_path), trajectory_tuner="chees",
              mesh_devices="off",   # single-device: the chees-enabled path
              warmup_cache=False)
    df = run_all_benchmarks(**kw)
    assert len(df) == 1
    row = df[0]
    assert row.get("error") is None or (isinstance(row.get("error"), float)
                                        and np.isnan(row.get("error")))
    assert row["trajectory_tuner"] == "chees"
    assert row["chees_trajectory_length"] > 0
    assert row["mean_num_steps"] > 0
    assert row["num_steps"] >= 1
    # realized-leapfrog accounting: per-draw counts are ceil(h*T/eps),
    # bounded by ceil(T/eps) (num_steps is round(T/eps), which can sit
    # one below), and n_gradients is their sum times n_chains
    l_max = int(np.ceil(row["chees_trajectory_length"] / row["step_size"]))
    assert 0 < row["n_gradients"] <= 200 * l_max * 16
    assert row["n_gradients"] == pytest.approx(
        row["mean_num_steps"] * 200 * 16, abs=1)
    # resume skips under the chees signature
    df2 = run_all_benchmarks(**kw)
    results = json.loads((tmp_path / "benchmark_results.json").read_text())
    assert len(results) == 1


@pytest.mark.slow
def test_run_all_benchmarks_chees_tuner_mesh_e2e(tmp_path):
    """--trajectory-tuner chees composes with --mesh: the warmup windows
    and the jittered sampling run shard_mapped over the 8-device CPU mesh
    (no grid fallback), and the row carries the chees products."""
    kw = dict(samplers=["hmc"], targets=["standard_normal"],
              grahmc_schedules=["constant"], dim=3, n_chains=16,
              num_warmup=120, num_samples=150, seed=0,
              output_dir=str(tmp_path), trajectory_tuner="chees",
              mesh_devices=8, warmup_cache=False)
    df = run_all_benchmarks(**kw)
    assert len(df) == 1
    row = df[0]
    assert row["trajectory_tuner"] == "chees"
    assert "chees_fell_back" not in df[0]
    assert row["chees_trajectory_length"] > 0
    assert row["n_gradients"] > 0
    assert bool(row["usable"])


def test_chees_cap_hit_returns_before_sampling(monkeypatch):
    """A cap-hit ChEES warmup must return its verdict WITHOUT paying
    Phase 2-4 (sampling/diagnostics/W2) — run_all_benchmarks discards the
    result and falls back to the grid anyway (review finding)."""
    import mcmc_tpu.tuning.chees as chees_mod

    def fake_warmup(sampler, lp, glp, init_pos, key, **kw):
        return 0.1, None, init_pos, {
            "trajectory_length": 25.6, "num_steps": 256,
            "max_steps_cap_hit": True, "halton_offset": 0}

    monkeypatch.setattr(chees_mod, "run_chees_warmup", fake_warmup)
    t = get_target("standard_normal", dim=3)
    r = run_single_benchmark_with_L(
        "hmc", t, "standard_normal", random.PRNGKey(7), n_chains=4,
        num_warmup=100, num_samples=100000, schedule_type="constant",
        num_steps=0, trajectory_tuner="chees")
    assert r["chees_cap_hit"] is True
    assert r["trajectory_tuner"] == "chees"
    assert "ess_bulk_min" not in r        # no diagnostics ran
    assert "sample_time" not in r         # no sampling ran


@pytest.mark.slow
def test_trajectory_tuner_flag_does_not_break_nuts_warmup_cache(tmp_path):
    """trajectory_tuner='chees' only applies to trajectory samplers: a
    NUTS call carrying the flag must keep its L-independent cache key and
    RESTORE its checkpoint on re-entry instead of re-paying warmup
    (review finding: the stale-checkpoint check used to discard every
    NUTS checkpoint because its warmup_info has no trajectory_length)."""
    t = get_target("standard_normal", dim=3)
    kw = dict(n_chains=4, num_warmup=200, num_samples=100,
              schedule_type="constant", num_steps=8,
              warmup_cache_dir=str(tmp_path), trajectory_tuner="chees")
    r1 = run_single_benchmark_with_L(
        "nuts", t, "standard_normal", random.PRNGKey(8), **kw)
    assert r1.get("error") is None and r1["warmup_restored"] is False
    r2 = run_single_benchmark_with_L(
        "nuts", t, "standard_normal", random.PRNGKey(8), **kw)
    assert r2.get("error") is None
    assert r2["warmup_restored"] is True, "NUTS checkpoint must be restored"


def test_resume_signature_keys_smc_particles():
    """Re-running with a different --smc-particles must re-measure the SMC
    row instead of skipping (the population size is the one knob that
    changes what the row measures at a fixed seed)."""
    from mcmc_tpu.benchmark.runner import _resume_signature

    s1 = _resume_signature("smc", "T", None, False, smc_particles=1024)
    s2 = _resume_signature("smc", "T", None, False, smc_particles=2048)
    assert s1 != s2
    assert s1 == _resume_signature("smc", "T", None, False,
                                   smc_particles=1024)
    # non-SMC signatures ignore the kwarg
    assert (_resume_signature("hmc", "T", None, True)
            == _resume_signature("hmc", "T", None, True, smc_particles=512))


def test_run_all_benchmarks_smc_e2e(tmp_path):
    """'--samplers smc' end-to-end: the row runs annealed SMC (auto-meshed
    over all visible devices — 8 on the CPU test host), estimates log Z ~ 0
    on a normalized target, carries the SMC schema (weighted ESS, no R-hat
    analogue), passes gates, and resumes by signature."""
    kw = dict(samplers=["smc"], targets=["standard_normal"],
              grahmc_schedules=["constant"], dim=3, n_chains=4,
              num_warmup=100, num_samples=200, seed=0,
              output_dir=str(tmp_path), smc_particles=1024,
              smc_move_steps=2, smc_num_steps=6)
    df1 = run_all_benchmarks(**kw)
    assert len(df1) == 1
    row = dict(df1[0])
    assert row.get("error") is None or (isinstance(row.get("error"), float)
                                        and np.isnan(row["error"]))
    assert row["sampler"] == "smc"
    # normalized target: the evidence estimate must sit near log Z = 0
    assert abs(row["log_z"]) < 0.25
    # no R-hat analogue for an exchangeable population (gates.py rationale)
    assert row["rhat_max"] is None or np.isnan(row["rhat_max"])
    assert row["ess_bulk_min"] >= 400          # weighted IS ESS
    assert row["usable"] and bool(row["stats_pass"])
    assert row["smc_particles"] == 1024
    assert row["n_gradients"] == row["smc_stages"] * 2 * 1024 * 6
    assert row["mesh_devices"] == 8            # auto-mesh engaged
    assert row["sliced_w2"] is not None and row["sliced_w2"] < 0.5
    # resume: the second invocation skips the completed signature
    df2 = run_all_benchmarks(**kw)
    assert len(df2) == 1
    results = json.loads((tmp_path / "benchmark_results.json").read_text())
    assert len(results) == 1 and results[0]["sampler"] == "smc"
