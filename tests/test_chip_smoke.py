"""chip_smoke.py's phase functions at tiny size on the CPU, with the kernel
under the Pallas interpreter (explicit backend='interpret'), and
its refusal to run without a GPU. On the card the same functions run at the
headline size (python chip_smoke.py)."""

import json
import subprocess
import sys

import pytest

import chip_smoke


@pytest.mark.parametrize("metric", ["diag", "dense"])
def test_kernel_parity_phase(metric):
    rec = chip_smoke.kernel_parity(n_chains=40, dim=10, num_steps=4,
                                   metric=metric, backend="interpret")
    assert rec["ok"], rec
    assert rec["agreeing_chains"] == 1.0
    assert rec["max_rel_dq"] <= chip_smoke.Q_REL_TOL
    assert "CompiledMemoryStats" in rec["memory_analysis"]


def test_api_pipeline_phase():
    rec = chip_smoke.api_pipeline(n_chains=64, dim=6, num_steps=4,
                                  num_samples=100, backend="interpret")
    assert rec["ok"], rec
    assert rec["backend"] == "interpret"
    assert rec["warmup_seconds"] > 0 and rec["sample_seconds"] > 0


def test_sampler_jobs_phase():
    recs = chip_smoke.sampler_jobs(n_chains=64, dim=6, backend="interpret")
    assert {r["job"] for r in recs} == {"hmc", "nuts_persistent", "rwmh",
                                        "chees", "tempering", "smc"}
    assert all(r["ok"] for r in recs), recs


def test_moment_gate_phase():
    recs = chip_smoke.moment_gate(n_chains=64, dim=6, num_samples=200,
                                  kernel_backend="interpret")
    assert [r["backend"] for r in recs] == ["interpret", "xla"]
    assert all(r["ok"] for r in recs), recs


def test_timing_phase_records_both_paths():
    (rec,) = chip_smoke.kernel_vs_xla_timing(
        (64,), dim=6, num_steps=4, num_samples=20, reps=1,
        kernel_backend="interpret")
    assert rec["xla_s"] > 0 and rec["kernel_s"] > 0
    assert rec["speedup"] == pytest.approx(rec["xla_s"] / rec["kernel_s"])


# One arm of each kind from a float32 CLI grid on the 10D correlated
# Gaussian (L=8 and L=16, 4,096 chains): the L=16 arm is the one whose
# warmup accepted a runaway proposal on an exact-zero uniform draw.
_GOOD_ARM = {"num_steps": 8, "usable": True, "rhat_max": 1.0054,
             "ess_bulk_min": 562228.2, "ess_tail_min": 1033499.1,
             "accept_rate": 0.9359, "step_size": 0.3622,
             "divergence_rate": 0.0, "mass_matrix_min": 0.9641,
             "mass_matrix_max": 0.969}
_BAD_ARM = {"num_steps": 16, "usable": False, "rhat_max": 11283912.0,
            "ess_bulk_min": 4104.2, "ess_tail_min": 4104.2,
            "accept_rate": 0.0, "step_size": 0.0334, "divergence_rate": 1.0,
            "mass_matrix_min": 2.69e18, "mass_matrix_max": 1.37e21}


@pytest.mark.parametrize("arm,expect", [
    (_GOOD_ARM, []),
    (_BAD_ARM, ["not usable", "divergence_rate=1.0",
                "mass_matrix=[2.69e+18, 1.37e+21]"]),
    (dict(_GOOD_ARM, rhat_max=float("nan")), ["rhat_max=nan"]),
    (dict(_GOOD_ARM, mass_matrix_max=2.5), ["mass_matrix=[0.9641, 2.5]"]),
])
def test_cli_phase_checks_every_grid_arm(arm, expect):
    """The cli phase fails on ANY arm of the L grid with a non-finite gate
    metric, an unusable row, a divergence storm or a blown-up metric, not
    only on the arm the grid selected."""
    assert chip_smoke._arm_problems(arm) == expect


def test_nuts_machine_rate_phase():
    (rec,) = chip_smoke.nuts_machine_rate(n_chains=32, dim=4, num_samples=2,
                                          steps_per_sample=8, reps=1)
    assert rec["ok"] and rec["useful_grads_per_sec"] > 0


def test_mesh_phases_cover_the_four_parity_groups():
    """--multi runs parity.py's four check groups as separate phases (one
    failure does not hide the others); here at tiny size on the 8-device
    CPU mesh, the kernel path resolving to XLA on the CPU."""
    phases = chip_smoke.mesh_phases(n_devices=8, n_chains=32, dim=4)
    assert [n for n, _ in phases] == ["mesh-shard_map", "mesh-gspmd",
                                      "mesh-collectives", "mesh-smc"]
    for name, fn in phases[1:3]:
        records = fn()
        assert records and all(r["ok"] for r in records), (name, records)


def test_main_refuses_to_run_without_gpu(capsys):
    """On the CPU the script exits non-zero before any phase and prints no
    result line."""
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr().out
    assert "no GPU" in out
    assert '"ok": true' not in out
    assert chip_smoke.main(["--multi"]) == 2


def test_cli_path_imports_only_jax_numpy_scipy(tmp_path):
    """The CLI path (run_all_benchmarks end to end, its CSV/JSON writer and
    summary) imports nothing beyond jax, numpy and scipy: pandas,
    matplotlib and seaborn are made unimportable in a fresh process."""
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('pandas', 'matplotlib', 'seaborn'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import jax
jax.config.update('jax_platforms', 'cpu')
import bench, chip_smoke, run_benchmarks
from mcmc_tpu.benchmark import run_all_benchmarks, print_summary
rows = run_all_benchmarks(samplers=['rwmh'], targets=['standard_normal'],
                          grahmc_schedules=['constant'], dim=2, n_chains=4,
                          num_warmup=100, num_samples=200, seed=0,
                          output_dir={str(tmp_path)!r}, mesh_devices='off',
                          warmup_cache=False)
print_summary(rows)
print('ROWS', len(rows))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ROWS 1" in out.stdout
    rows = json.loads((tmp_path / "benchmark_results.json").read_text())
    assert rows[0]["sampler"] == "rwmh"
