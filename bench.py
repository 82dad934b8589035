"""Benchmark: sampler throughput and measured ESS on the GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "device": {...}, "extras": {...}}

Primary metric: GRAHMC chain-steps/sec (chains x MH transitions / sec, each
transition = 16 conformal-leapfrog substeps with the funnel gradient) at
65,536 chains on the 50D Neal's funnel, at a tuned operating point (the step
size is dual-averaging tuned on-device to accept ~0.65). The trajectory
backend is resolved as users get it (backend='auto': the fused kernel on a
GPU) and recorded.

extras:
  - measured min bulk-ESS/sec over ALL 65,536 chains' collected history via
    the chain-chunked streaming estimator,
  - persistent NUTS (endpoint and multinomial schemes) useful-gradient
    evals/sec and measured ESS/sec at 65,536 chains,
  - RWMH chain-steps/sec at 65,536 chains (10D standard normal),
  - ChEES cold warmup seconds and jittered sampling transitions/sec,
  - tempered GRAHMC replica-transitions/sec and swap acceptance,
  - SMC particle-leapfrogs/sec and log-Z on the 10D mixture.

Timing: every timed call ends in block_until_ready; each row is compiled by
a call of the same shape first and reports the median of its timed reps.
The device record names platform, kind, count and power limit; without a GPU
the script exits non-zero and prints no result.

Run on the GPU: python bench.py
"""

import json
import sys
import time

DIM = 50
NUM_STEPS = 16          # leapfrog substeps per GRAHMC transition
CHAINS = 65536
TIMED_SAMPLES = 768
ESS_SAMPLES = 192       # full-history ESS run: 192 x 65536 x 50 f32 = 2.5 GB
NUTS_STEPS_PER_SAMPLE = 64
NUTS_TIMED_SAMPLES = 192
RWMH_DIM = 10
RWMH_TIMED_SAMPLES = 16384
RWMH_SCALE = 2.38 / RWMH_DIM ** 0.5  # Roberts-Rosenthal optimal scaling


def _log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _median_time(run, n_reps=5):
    """Median wall time of n_reps calls of run(rep); run must return arrays,
    which are waited for with block_until_ready inside the timed region.
    Returns (median seconds, last result)."""
    import jax
    dts, out = [], None
    for rep in range(n_reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(rep))
        dts.append(time.perf_counter() - t0)
    return sorted(dts)[len(dts) // 2], out


def _tune_step(target, kind, init):
    """Dual-averaging tune the step size to accept ~0.65 on-device."""
    import jax
    import jax.numpy as jnp
    from jax import random
    from mcmc_tpu.samplers import grahmc_run, nuts_run_persistent
    from mcmc_tpu.samplers.grahmc import constant_schedule
    from mcmc_tpu.tuning import (da_init, da_update, da_step_size,
                                 da_final_step_size)

    da = da_init(0.1)
    pos = init
    for it in range(30 if kind == "grahmc" else 15):
        eps = float(da_step_size(da))
        key = random.PRNGKey(100 + it)
        if kind == "grahmc":
            res = grahmc_run(key, target.log_prob_fn, pos, eps, NUM_STEPS,
                             1.0, 1.0, 10, friction_schedule=constant_schedule,
                             value_and_grad_fn=target.value_and_grad_fn,
                             collect_chains=8)
            acc = jnp.mean(res.accept_rate)
        else:
            res = nuts_run_persistent(
                key, target.log_prob_fn, pos, step_size=eps, num_samples=1,
                steps_per_sample=96, value_and_grad_fn=target.value_and_grad_fn,
                collect_chains=8)
            acc = jnp.nanmean(res.info["mean_accept_probs"])
        pos = jax.block_until_ready(res.final_state.position)
        da = da_update(da, acc, 0.65)
    step = float(da_final_step_size(da))
    _log(f"tuned {kind} step_size={step:.4f}")
    return step


def _ess_per_sec(samples, dt, label):
    """Min bulk-ESS over ALL collected chains (streaming), per sampling sec."""
    import jax.numpy as jnp
    from mcmc_tpu.diagnostics import ess_bulk_chunked
    t0 = time.perf_counter()
    ess = ess_bulk_chunked(samples, chain_chunk=8192, dim_chunk=4)
    ess_min = float(jnp.min(ess))
    _log(f"{label}: bulk-ESS over {samples.shape[1]:,} chains x "
         f"{samples.shape[0]} draws: min={ess_min:,.0f} "
         f"(diagnostics {time.perf_counter() - t0:.1f}s)")
    return ess_min / dt


def measure(extras):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import random

    from mcmc_tpu.ops.padded_targets import resolve_backend
    from mcmc_tpu.samplers import grahmc_run, nuts_run_persistent, rwmh_run
    from mcmc_tpu.samplers.grahmc import constant_schedule, tanh_schedule
    from mcmc_tpu.samplers.smc import resolve_move_backend, smc_run
    from mcmc_tpu.samplers.tempered import tempered_run
    from mcmc_tpu.targets import get_target, neals_funnel, standard_normal
    from mcmc_tpu.tuning.chees import chees_run, run_chees_warmup

    target = neals_funnel(DIM)
    init = (random.normal(random.PRNGKey(0), (CHAINS, DIM)) * 0.5
            ).astype(jnp.float32)

    # ---- GRAHMC ----------------------------------------------------------
    g_step = _tune_step(target, "grahmc", init)
    kw = dict(step_size=g_step, num_steps=NUM_STEPS, gamma=1.0, steepness=1.0,
              burn_in=0, friction_schedule=constant_schedule,
              value_and_grad_fn=target.value_and_grad_fn)
    extras["grahmc_backend"] = resolve_backend("auto",
                                               target.value_and_grad_fn)

    def g_run(rep, n=TIMED_SAMPLES, collect=64):
        return grahmc_run(random.PRNGKey(2 + rep), target.log_prob_fn, init,
                          num_samples=n, collect_chains=collect, **kw)
    jax.block_until_ready(g_run(99))
    dt, res = _median_time(g_run)
    rate = CHAINS * TIMED_SAMPLES / dt
    extras["grahmc_accept"] = float(res.accept_rate.mean())
    extras["grahmc_step_size"] = g_step
    _log(f"GRAHMC: {dt:.4f}s for {TIMED_SAMPLES} x {CHAINS} chains "
         f"(accept={extras['grahmc_accept']:.3f}, "
         f"backend={extras['grahmc_backend']})")

    # full-history run for ESS/sec over all chains
    jax.block_until_ready(g_run(98, ESS_SAMPLES, None))
    dt_full, res_full = _median_time(
        lambda rep: g_run(10 + rep, ESS_SAMPLES, None), n_reps=1)
    extras["grahmc_ess_per_sec"] = _ess_per_sec(res_full.samples, dt_full,
                                                "GRAHMC")

    # ---- persistent NUTS, both proposal schemes --------------------------
    n_step = _tune_step(target, "nuts", init)
    extras["nuts_step_size"] = n_step
    for scheme in ("endpoint", "multinomial"):
        nkw = dict(step_size=n_step, num_samples=NUTS_TIMED_SAMPLES,
                   steps_per_sample=NUTS_STEPS_PER_SAMPLE,
                   value_and_grad_fn=target.value_and_grad_fn,
                   proposal_scheme=scheme)
        jax.block_until_ready(nuts_run_persistent(
            random.PRNGKey(4), target.log_prob_fn, init, **nkw).samples)
        rates = []
        for rep in range(3):
            t0 = time.perf_counter()
            nres = jax.block_until_ready(nuts_run_persistent(
                random.PRNGKey(5 + rep), target.log_prob_fn, init, **nkw))
            dt_n = time.perf_counter() - t0
            rates.append(float(nres.info["n_leapfrogs"]) / dt_n)
        tag = "nuts" if scheme == "endpoint" else "nuts_multinomial"
        extras[f"{tag}_useful_grads_per_sec"] = float(np.median(rates))
        extras[f"{tag}_accept"] = float(jnp.nanmean(
            nres.info["mean_accept_probs"]))
        extras[f"{tag}_ess_per_sec"] = _ess_per_sec(nres.samples, dt_n, tag)
        _log(f"NUTS {scheme}: {extras[f'{tag}_useful_grads_per_sec']:.4g} "
             f"useful grads/s")

    # ---- RWMH ------------------------------------------------------------
    rt = standard_normal(RWMH_DIM)
    r_init = (random.normal(random.PRNGKey(6), (CHAINS, RWMH_DIM)) * 0.3
              ).astype(jnp.float32)

    def r_run(rep):
        return rwmh_run(random.PRNGKey(8 + rep), rt.log_prob_fn, r_init,
                        num_samples=RWMH_TIMED_SAMPLES, scale=RWMH_SCALE,
                        collect_chains=64)
    jax.block_until_ready(r_run(99))
    rdt, rres = _median_time(r_run)
    extras["rwmh_chain_steps_per_sec"] = CHAINS * RWMH_TIMED_SAMPLES / rdt
    extras["rwmh_accept"] = float(rres.accept_rate.mean())

    # ---- ChEES: cold warmup + jittered sampling --------------------------
    ct = get_target("neals_funnel_noncentered", dim=20)
    c_chains = 2048
    c_init = (random.normal(random.PRNGKey(40), (c_chains, 20)) * 0.5
              ).astype(jnp.float32)
    t0 = time.perf_counter()
    c_step, c_mass, c_pos, c_info = run_chees_warmup(
        "hmc", ct.log_prob_fn, None, c_init, random.PRNGKey(41),
        num_warmup=2500, value_and_grad_fn=ct.value_and_grad_fn)
    jax.block_until_ready(c_pos)
    extras["chees_warmup_seconds"] = time.perf_counter() - t0
    extras["chees_T"] = c_info["trajectory_length"]

    def c_run(rep):
        return chees_run(random.PRNGKey(43 + rep), ct.log_prob_fn, c_pos,
                         c_step, c_info["trajectory_length"], 8192,
                         halton_offset=16384 + 8192 * rep,
                         inv_mass_matrix=c_mass, collect_chains=64,
                         value_and_grad_fn=ct.value_and_grad_fn)
    jax.block_until_ready(c_run(99))
    cdt, cres = _median_time(c_run, n_reps=3)
    extras["chees_transitions_per_sec"] = c_chains * 8192 / cdt
    extras["chees_accept"] = float(cres.accept_rate.mean())

    # ---- tempered GRAHMC: 6-rung ladder on the 10D mixture ---------------
    mt = get_target("gaussian_mixture", dim=10)
    t_K, t_chains, t_draws = 6, 8192, 256
    t_init = mt.init_sampler(random.PRNGKey(50), t_chains)
    tkw = dict(step_size=0.5, num_steps=NUM_STEPS, num_samples=t_draws,
               n_temps=t_K, beta_min=0.02, collect_chains=64, gamma=0.1,
               steepness=5.0, friction_schedule=tanh_schedule,
               value_and_grad_fn=mt.value_and_grad_fn)

    def t_run(rep):
        return tempered_run(random.PRNGKey(52 + rep), mt.log_prob_fn, t_init,
                            **tkw)
    jax.block_until_ready(t_run(99))
    tdt, tres = _median_time(t_run, n_reps=3)
    extras["tempered_replica_transitions_per_sec"] = (
        t_K * t_chains * t_draws / tdt)
    extras["tempered_swap_accept"] = [
        float(x) for x in np.asarray(tres.info["swap_accept_rate"])]
    extras["tempered_cold_accept"] = float(tres.accept_rate.mean())

    # ---- annealed SMC: evidence on the 10D mixture -----------------------
    smt = mt
    s_P, s_L, s_moves = 32768, 8, 2
    skw = dict(n_particles=s_P, dim=10, step_size=0.4, num_steps=s_L,
               move_steps=s_moves, base_scale=6.0,
               value_and_grad_fn=smt.value_and_grad_fn, final_resample=True)
    extras["smc_move_backend"] = resolve_move_backend(
        "auto", smt.value_and_grad_fn, False, None)
    jax.block_until_ready(smc_run(random.PRNGKey(60), smt.log_prob_fn,
                                  **skw).particles)
    s_rates = []
    for rep in range(3):
        t0 = time.perf_counter()
        s_last = jax.block_until_ready(
            smc_run(random.PRNGKey(61 + rep), smt.log_prob_fn, **skw))
        stages = int(s_last.info["n_stages"])
        s_rates.append(s_P * stages * s_moves * s_L
                       / (time.perf_counter() - t0))
    extras["smc_particle_leapfrogs_per_sec"] = float(np.median(s_rates))
    extras["smc_log_z"] = float(s_last.log_Z)
    extras["smc_stages"] = int(s_last.info["n_stages"])
    return rate


def main():
    from mcmc_tpu.utils import enable_compilation_cache
    from mcmc_tpu.utils.profiling import device_record

    enable_compilation_cache()
    device = device_record()
    if device["platform"] != "gpu":
        _log(f"no GPU (platform {device['platform']!r}): nothing to measure")
        sys.exit(1)
    _log(f"device: {device}")
    extras = {}
    rate = measure(extras)
    print(json.dumps({
        "metric": "grahmc_chain_steps_per_sec_50d_funnel_tuned",
        "value": rate,
        "unit": "chain_steps/s",
        "device": device,
        "extras": extras,
    }))


if __name__ == "__main__":
    main()
