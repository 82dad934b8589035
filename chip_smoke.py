"""Chip smoke test: mcmc_tpu's main paths on the GPU at the headline size.

    python chip_smoke.py           # one GPU: phases 1-5 below
    python chip_smoke.py --multi   # four GPUs: the mesh parity checks only

The headline job is Neal's funnel at 50D, 65,536 chains, GRAHMC with L=16.
Phases (one process, no JAX child processes):

1. kernel: compile the fused trajectory kernel at 65,536 x 50 with a
   diagonal and a dense metric, print compiled.memory_analysis(), and compare
   it with the plain XLA trajectory (float32 matmuls at "highest") on the same
   injected randomness. Tolerance: |dq| <= 1e-4 * (1 + |q|) on every
   coordinate, accept decisions agreeing, on >= 99.9% of chains.
2. api: run_adaptive_warmup -> grahmc_run -> compute_diagnostics and the
   gates at the headline shape; a short job through each of HMC, persistent
   NUTS, RWMH, ChEES, tempering and SMC with backend='auto'; the moment
   z-test gate on a 50D standard normal through the kernel and through XLA.
3. cli: run_all_benchmarks for one target and a small L grid, in process,
   and a check of the row it writes and of every arm of its grid.
4. timing: grahmc_run wall time, kernel against XLA, at 65,536 and 4,096
   chains (block_until_ready, warm compile, median of reps), and the
   persistent-NUTS XLA machine's useful gradients/s at 65,536 chains.
5. tests: the `gpu`-marked tests through pytest.main, in process.

Any failed phase makes the exit code non-zero. On success the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU the script exits non-zero before any phase.
"""

import argparse
import json
import math
import os
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
HEADLINE_CHAINS = 65536
HEADLINE_DIM = 50
HEADLINE_STEPS = 16
Q_REL_TOL = 1e-4            # |dq| <= Q_REL_TOL * (1 + |q|)
MIN_AGREEING_CHAINS = 0.999
# Every arm of the cli phase's L grid on the 10D correlated Gaussian, whose
# marginal variances are all 1: finite gate metrics, at most 1% divergent
# transitions, a learned diagonal metric within a factor 2 of 1.
CLI_FINITE_KEYS = ("rhat_max", "ess_bulk_min", "ess_tail_min",
                   "accept_rate", "step_size")
CLI_MAX_DIVERGENCE = 0.01
CLI_MASS_RANGE = (0.5, 2.0)


def _say(msg):
    print(msg, flush=True)


def _median_seconds(fn, reps):
    """Median wall time of `reps` calls of fn(), each ending in
    block_until_ready on its result."""
    import jax
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


# ---------------------------------------------------------------- phase 1

def kernel_parity(n_chains=HEADLINE_CHAINS, dim=HEADLINE_DIM,
                  num_steps=HEADLINE_STEPS, metric="diag",
                  backend="pallas"):
    """Compile the fused kernel (one transition, injected randomness) and
    compare it with the XLA integrator + MH accept on the same inputs."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import random

    from mcmc_tpu.ops.fused_trajectory import make_debug_trajectory
    from mcmc_tpu.samplers.grahmc import tanh_schedule
    from mcmc_tpu.samplers.trajectory import (integrate_trajectory,
                                              kinetic_energy)
    from mcmc_tpu.targets import neals_funnel

    t = neals_funnel(dim)
    f32 = jnp.float32
    q = (random.normal(random.PRNGKey(0), (n_chains, dim)) * 0.5).astype(f32)
    lp, grad = t.value_and_grad_fn(q)
    lp, grad = lp.astype(f32), grad.astype(f32)
    p0 = random.normal(random.PRNGKey(1), (n_chains, dim), f32)
    u = random.uniform(random.PRNGKey(2), (n_chains,), f32)
    if metric == "dense":
        a = random.normal(random.PRNGKey(5), (dim, dim), f32)
        inv_mass = (a @ a.T / dim + jnp.eye(dim)).astype(f32)
    else:
        inv_mass = jnp.linspace(0.5, 1.5, dim, dtype=f32)
    eps, gamma, steep = 0.05, 0.3, 0.5

    run = make_debug_trajectory(t.value_and_grad_fn, num_steps,
                                tanh_schedule, backend=backend)
    kernel = jax.jit(lambda *a: run(*a, eps, gamma, steep, inv_mass))
    t0 = time.perf_counter()
    compiled = kernel.lower(q, lp, grad, p0, u).compile()
    compile_s = time.perf_counter() - t0
    q_k, lp_k, _, acc_k, dh_k = compiled(q, lp, grad, p0, u)

    @jax.jit
    def xla(q, lp, grad, p0, u):
        with jax.default_matmul_precision("highest"):
            qx, px, lpx, _ = integrate_trajectory(
                q, p0, lp, grad, t.value_and_grad_fn, eps, num_steps,
                inv_mass, friction_schedule=tanh_schedule, gamma_max=gamma,
                steepness=steep)
            h0 = -lp + kinetic_energy(p0, inv_mass)
            h1 = -lpx + kinetic_energy(-px, inv_mass)
        accept = jnp.log(u) < jnp.minimum(0.0, h0 - h1)
        return jnp.where(accept[:, None], qx, q), accept

    q_x, acc_x = xla(q, lp, grad, p0, u)
    q_k, q_x = np.asarray(q_k, np.float64), np.asarray(q_x, np.float64)
    rel = np.abs(q_k - q_x) / (1.0 + np.abs(q_x))
    agree = (np.asarray(acc_k) == np.asarray(acc_x)) & np.all(
        rel <= Q_REL_TOL, axis=1)
    rec = {
        "metric": metric, "n_chains": n_chains, "dim": dim,
        "compile_seconds": compile_s,
        "memory_analysis": str(compiled.memory_analysis()),
        "max_rel_dq": float(rel.max()),
        "accept_agreement": float(np.mean(np.asarray(acc_k)
                                          == np.asarray(acc_x))),
        "agreeing_chains": float(agree.mean()),
        "accept_rate": float(np.mean(np.asarray(acc_k))),
        "finite": bool(np.all(np.isfinite(q_k))
                       and np.all(np.isfinite(np.asarray(dh_k)))),
    }
    rec["ok"] = rec["finite"] and rec["agreeing_chains"] >= \
        MIN_AGREEING_CHAINS
    return rec


# ---------------------------------------------------------------- phase 2

def api_pipeline(n_chains=HEADLINE_CHAINS, dim=HEADLINE_DIM,
                 num_steps=HEADLINE_STEPS, num_samples=200,
                 backend="auto"):
    """Warmup -> sampling -> diagnostics -> gates through the package API
    on the dim-D funnel, as a user would call it."""
    import jax
    import jax.numpy as jnp
    from jax import random

    from mcmc_tpu.diagnostics import compute_diagnostics, evaluate_gates
    from mcmc_tpu.ops.padded_targets import resolve_backend
    from mcmc_tpu.samplers import grahmc_run
    from mcmc_tpu.samplers.grahmc import tanh_schedule
    from mcmc_tpu.targets import neals_funnel
    from mcmc_tpu.tuning import run_adaptive_warmup

    t = neals_funnel(dim)
    init = t.init_sampler(random.PRNGKey(0), n_chains).astype(jnp.float32)
    t0 = time.perf_counter()
    step, inv_mass, pos, info = run_adaptive_warmup(
        "grahmc", t.log_prob_fn, None, init, random.PRNGKey(1),
        num_warmup=600, schedule_type="tanh", num_steps=num_steps,
        value_and_grad_fn=t.value_and_grad_fn, backend=backend,
        exploration_steps=200, adaptation_windows=[100, 200],
        cooldown_steps=100, max_iter_step=100, gamma_samples_per_eval=40)
    jax.block_until_ready(pos)
    warmup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = grahmc_run(random.PRNGKey(2), t.log_prob_fn, pos, step, num_steps,
                     info["gamma"], info["steepness"], num_samples,
                     inv_mass_matrix=inv_mass, friction_schedule=tanh_schedule,
                     value_and_grad_fn=t.value_and_grad_fn, backend=backend)
    jax.block_until_ready(res.samples)
    sample_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    diag = compute_diagnostics(res.samples)
    diag_s = time.perf_counter() - t0
    gates = evaluate_gates(diag["rhat_max"], diag["ess_bulk_min"],
                           diag["ess_tail_min"],
                           float(res.info["divergence_rate"]), num_samples)
    rec = {
        "backend": resolve_backend(backend, t.value_and_grad_fn),
        "n_chains": n_chains, "dim": dim,
        "warmup_seconds": warmup_s, "sample_seconds": sample_s,
        "diagnostics_seconds": diag_s, "step_size": float(step),
        "gamma": float(info["gamma"]),
        "accept_rate": float(res.accept_rate.mean()),
        "rhat_max": diag["rhat_max"], "ess_bulk_min": diag["ess_bulk_min"],
        "divergence_rate": float(res.info["divergence_rate"]),
        "usable": bool(gates["usable"]),
        "finite": bool(jnp.all(jnp.isfinite(res.samples))),
    }
    # The funnel's neck at 200 draws is not a quality claim; the pipeline
    # must run end to end and produce finite, moving chains.
    rec["ok"] = (rec["finite"] and 0.05 < rec["accept_rate"] <= 1.0
                 and rec["ess_bulk_min"] > 0)
    return rec


def sampler_jobs(n_chains=4096, dim=HEADLINE_DIM, backend="auto"):
    """A short job through each sampler family with backend='auto' (the
    resolver decides) on the dim-D standard normal."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import random

    from mcmc_tpu.samplers import (hmc_run, nuts_run_persistent, rwmh_run,
                                   smc_run, tempered_run)
    from mcmc_tpu.targets import standard_normal
    from mcmc_tpu.tuning.chees import chees_run, run_chees_warmup

    t = standard_normal(dim)
    vag = t.value_and_grad_fn
    init = random.normal(random.PRNGKey(0), (n_chains, dim), jnp.float32)
    jobs = {
        "hmc": lambda: hmc_run(random.PRNGKey(1), t.log_prob_fn, init, 0.3,
                               8, 50, value_and_grad_fn=vag,
                               collect_chains=64, backend=backend),
        "nuts_persistent": lambda: nuts_run_persistent(
            random.PRNGKey(2), t.log_prob_fn, init, 0.3, 20,
            steps_per_sample=16, value_and_grad_fn=vag, collect_chains=64),
        "rwmh": lambda: rwmh_run(random.PRNGKey(3), t.log_prob_fn, init, 200,
                                 2.38 / dim ** 0.5, collect_chains=64),
        "tempering": lambda: tempered_run(
            random.PRNGKey(4), t.log_prob_fn, init, 0.3, 8, 50, n_temps=3,
            value_and_grad_fn=vag, collect_chains=64, backend=backend),
        "smc": lambda: smc_run(random.PRNGKey(5), t.log_prob_fn,
                               n_particles=n_chains, dim=dim, step_size=0.3,
                               num_steps=8, base_scale=2.0,
                               value_and_grad_fn=vag, move_backend=backend),
    }

    def chees():
        step, mass, pos, info = run_chees_warmup(
            "hmc", t.log_prob_fn, None, init, random.PRNGKey(6),
            num_warmup=300, value_and_grad_fn=vag, exploration_steps=100,
            adaptation_windows=[100], cooldown_steps=100)
        return chees_run(random.PRNGKey(7), t.log_prob_fn, pos, step,
                         info["trajectory_length"], 50, inv_mass_matrix=mass,
                         value_and_grad_fn=vag, collect_chains=64,
                         backend=backend)
    jobs["chees"] = chees

    out = []
    for name, job in jobs.items():
        t0 = time.perf_counter()
        res = jax.block_until_ready(job())
        seconds = time.perf_counter() - t0
        draws = res.particles if name == "smc" else res.samples
        flat = np.asarray(draws, np.float64).reshape(-1, dim)
        rec = {"job": name, "seconds_with_compile": seconds,
               "finite": bool(np.all(np.isfinite(flat))),
               "mean_abs_mean": float(np.abs(flat.mean(0)).mean())}
        if name == "smc":
            rec["log_z"] = float(res.log_Z)
            rec["ok"] = rec["finite"] and abs(rec["log_z"]) < 0.5
        else:
            rec["accept"] = float(jnp.nanmean(res.accept_rate))
            rec["ok"] = rec["finite"] and rec["accept"] > 0.05
        out.append(rec)
    return out


def moment_gate(n_chains=4096, dim=HEADLINE_DIM, num_samples=400,
                kernel_backend="pallas"):
    """The Bonferroni moment z-test gate (diagnostics.check_summary_
    statistics) on the dim-D standard normal, through the fused kernel and
    through the XLA integrator, from stationary starting points."""
    import jax.numpy as jnp
    from jax import random

    from mcmc_tpu.diagnostics import (check_summary_statistics,
                                      compute_diagnostics)
    from mcmc_tpu.samplers import hmc_run
    from mcmc_tpu.targets import standard_normal

    t = standard_normal(dim)
    init = random.normal(random.PRNGKey(10), (n_chains, dim), jnp.float32)
    out = []
    for backend in (kernel_backend, "xla"):
        res = hmc_run(random.PRNGKey(11), t.log_prob_fn, init, 0.25, 8,
                      num_samples, burn_in=50, value_and_grad_fn=
                      t.value_and_grad_fn, backend=backend)
        gate = check_summary_statistics(compute_diagnostics(res.samples), t)
        out.append({"backend": backend, "max_z": gate["max_z"],
                    "threshold": gate["threshold"],
                    "accept": float(res.accept_rate.mean()),
                    "ok": bool(gate["pass"])})
    return out


# ---------------------------------------------------------------- phase 3

def _arm_problems(arm):
    """What is wrong with one arm of the CLI's L grid on the correlated
    Gaussian: a non-finite gate metric, an unusable row, a divergence storm
    or a learned diagonal metric off the target's unit marginal variances."""
    problems = [f"{k}={arm.get(k)}" for k in CLI_FINITE_KEYS
                if arm.get(k) is None or not math.isfinite(arm[k])]
    if not arm.get("usable"):
        problems.append("not usable")
    if (arm.get("divergence_rate") or 0.0) > CLI_MAX_DIVERGENCE:
        problems.append(f"divergence_rate={arm['divergence_rate']}")
    lo, hi = CLI_MASS_RANGE
    m_lo, m_hi = arm.get("mass_matrix_min"), arm.get("mass_matrix_max")
    if m_lo is None or m_hi is None or not lo <= m_lo <= m_hi <= hi:
        problems.append(f"mass_matrix=[{m_lo}, {m_hi}]")
    return problems


def cli_row(output_dir, n_chains=4096, dim=10, expect_backend="pallas"):
    """run_all_benchmarks in process: one target, HMC, a two-point L grid.
    The row it writes must carry the resolved backend, and EVERY arm of
    the grid (not only the selected one) must pass _arm_problems."""
    from mcmc_tpu.benchmark import run_all_benchmarks

    rows = run_all_benchmarks(
        samplers=["hmc"], targets=["correlated_gaussian"],
        grahmc_schedules=["constant"], dim=dim, n_chains=n_chains,
        num_warmup=500, num_samples=500, seed=0, output_dir=output_dir,
        num_steps_grid=[8, 16], mass_matrix_modes=[True], mesh_devices="off",
        warmup_cache=False)
    with open(os.path.join(output_dir, "benchmark_results.json")) as f:
        written = json.load(f)
    row = written[0]
    arms = (row.get("grid_search_info") or {}).get("all_results") or []
    rec = {"rows": len(rows), "backend": row.get("backend"),
           "num_steps": row.get("num_steps"), "error": row.get("error"),
           "arms": [{k: a.get(k) for k in (
               "num_steps", "usable", "quality_pass", "rhat_max",
               "ess_bulk_min", "accept_rate", "divergence_rate",
               "mass_matrix_min", "mass_matrix_max", "z_score_max")}
               | {"problems": _arm_problems(a)} for a in arms]}
    rec["ok"] = (len(rows) == 1 and rec["error"] is None
                 and rec["backend"] == expect_backend
                 and len(arms) == 2
                 and not any(a["problems"] for a in rec["arms"]))
    return rec


# ---------------------------------------------------------------- phase 4

def kernel_vs_xla_timing(chain_counts=(HEADLINE_CHAINS, 4096),
                         dim=HEADLINE_DIM, num_steps=HEADLINE_STEPS,
                         num_samples=200, reps=3,
                         kernel_backend="pallas"):
    """grahmc_run wall time through the fused kernel and through the XLA
    scan, compiled first, median of reps, in turns (xla, kernel, kernel,
    xla order of first calls)."""
    import jax.numpy as jnp
    from jax import random

    from mcmc_tpu.samplers import grahmc_run
    from mcmc_tpu.samplers.grahmc import tanh_schedule
    from mcmc_tpu.targets import neals_funnel

    t = neals_funnel(dim)
    out = []
    for n in chain_counts:
        init = t.init_sampler(random.PRNGKey(0), n).astype(jnp.float32)
        times = {}
        for backend in ("xla", kernel_backend):
            def run(backend=backend):
                return grahmc_run(random.PRNGKey(1), t.log_prob_fn, init,
                                  0.05, num_steps, 0.3, 0.5, num_samples,
                                  friction_schedule=tanh_schedule,
                                  value_and_grad_fn=t.value_and_grad_fn,
                                  backend=backend).samples
            t0 = time.perf_counter()
            _median_seconds(run, 1)
            first = time.perf_counter() - t0
            times[backend] = (first, _median_seconds(run, reps))
        out.append({"n_chains": n, "num_samples": num_samples,
                    "xla_first_call_s": times["xla"][0],
                    "xla_s": times["xla"][1],
                    "kernel_first_call_s": times[kernel_backend][0],
                    "kernel_s": times[kernel_backend][1],
                    "speedup": times["xla"][1] / times[kernel_backend][1],
                    "ok": True})
    return out


def nuts_machine_rate(n_chains=HEADLINE_CHAINS, dim=HEADLINE_DIM,
                      num_samples=16, steps_per_sample=64, reps=3):
    """Useful gradients per second of the persistent-NUTS XLA machine on
    the funnel (every machine slot is one executed leapfrog)."""
    import jax.numpy as jnp
    from jax import random

    from mcmc_tpu.samplers import nuts_run_persistent
    from mcmc_tpu.targets import neals_funnel

    t = neals_funnel(dim)
    init = t.init_sampler(random.PRNGKey(0), n_chains).astype(jnp.float32)

    def run():
        return nuts_run_persistent(
            random.PRNGKey(1), t.log_prob_fn, init, 0.1, num_samples,
            steps_per_sample=steps_per_sample,
            value_and_grad_fn=t.value_and_grad_fn, collect_chains=64)
    t0 = time.perf_counter()
    res = run()
    float(res.info["n_leapfrogs"])
    first = time.perf_counter() - t0
    seconds = _median_seconds(run, reps)
    grads = float(res.info["n_leapfrogs"])
    return [{"n_chains": n_chains, "first_call_s": first, "seconds": seconds,
             "useful_grads_per_sec": grads / seconds,
             "mean_tree_depth": float(jnp.mean(res.info["mean_tree_depth"])),
             "ok": grads > 0}]


# ---------------------------------------------------------------- phase 5

def gpu_tests():
    """The `gpu`-marked tests, in this process (the card is already held
    by it). JAX_PLATFORMS names the GPU so tests/conftest.py does not pin
    the CPU."""
    import pytest
    os.environ["JAX_PLATFORMS"] = "cuda"
    code = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                        "-p", "no:randomly", os.path.join(REPO, "tests")])
    return [{"pytest_exit_code": int(code), "ok": int(code) == 0}]


# ---------------------------------------------------------------- mesh

def mesh_phases(n_devices=4, n_chains=HEADLINE_CHAINS, dim=HEADLINE_DIM):
    """parallel/parity.py's four check groups on an n-device mesh of the
    real devices, one phase each: [(name, fn)]."""
    from mcmc_tpu.parallel import make_mesh, parity

    return [(f"mesh-{name}", run) for name, run in parity.mesh_checks(
        make_mesh(n_devices), n_chains, dim)]


def _run_phase(name, fn, failures):
    _say(f"=== phase {name}")
    t0 = time.perf_counter()
    try:
        records = fn()
    except Exception:
        traceback.print_exc(file=sys.stdout)
        failures.append(name)
        return
    for rec in records if isinstance(records, list) else [records]:
        _say(f"[{name}] " + json.dumps(rec, default=str))
        if not rec.get("ok", False):
            failures.append(name)
    _say(f"=== phase {name} done in {time.perf_counter() - t0:.1f}s")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--multi", action="store_true",
                        help="run only the mesh parity checks on 4 GPUs")
    args = parser.parse_args(argv)

    from mcmc_tpu.utils import enable_compilation_cache
    enable_compilation_cache()
    from mcmc_tpu.utils.profiling import device_record

    device = device_record()
    _say(f"nvidia-smi: {device['name_power_limit']}")
    _say(f"device_kind: {device['kind']}")
    _say(f"device count: {device['count']}")
    if device["platform"] != "gpu":
        _say(f"no GPU: JAX found platform {device['platform']!r}")
        return 2
    want = 4 if args.multi else 1
    if device["count"] < want:
        _say(f"need {want} GPUs, found {device['count']}")
        return 2

    failures = []
    if args.multi:
        for name, fn in mesh_phases():
            _run_phase(name, fn, failures)
    else:
        out_dir = os.path.join(REPO, "chiprun_out", "chip_smoke_cli")
        os.makedirs(out_dir, exist_ok=True)
        for name, fn in (
                ("kernel-diag", lambda: kernel_parity(metric="diag")),
                ("kernel-dense", lambda: kernel_parity(metric="dense")),
                ("api", api_pipeline),
                ("samplers", sampler_jobs),
                ("moment-gate", moment_gate),
                ("cli", lambda: cli_row(out_dir)),
                ("timing", kernel_vs_xla_timing),
                ("nuts-machine", nuts_machine_rate),
                ("gpu-tests", gpu_tests)):
            _run_phase(name, fn, failures)
    if failures:
        _say(f"FAILED phases: {sorted(set(failures))}")
        return 1
    _say(f"nvidia-smi: {device['name_power_limit']}")
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
