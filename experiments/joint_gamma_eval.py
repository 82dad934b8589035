"""Joint friction tuning vs the two-phase pipeline (round 4, VERDICT r3 #8).

Measures, per target, both GRAHMC warmup pipelines at matched budgets:

  grid:  ChEES warmup (step/mass/T) + separate sequential ESJD grid for
         gamma (the reference-contract two-phase pipeline; the gamma grid
         re-runs DA per candidate — reference tuning/adaptation.py:279-300)
  joint: ONE ChEES warmup producing (step, mass, T, gamma) via interleaved
         SPSA on the acceptance-weighted sphered ESJD (tuning/chees.py)

then runs the identical jittered sampling phase (chees_run) at each tuned
operating point and reports warmup wall-clock, warmup gradient count, the
tuned (eps, T, gamma), and min-bulk-ESS per leapfrog gradient. The VERDICT
acceptance bar: joint ESS/grad >= grid ESS/grad on the funnel and
Rosenbrock configs, at lower warmup cost.

Run on the GPU:  python experiments/joint_gamma_eval.py
CPU (small): python experiments/joint_gamma_eval.py --cpu --chains 256
"""

import argparse
import json
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--chains", type=int, default=2048)
    ap.add_argument("--num-warmup", type=int, default=2500)
    ap.add_argument("--num-samples", type=int, default=2048)
    ap.add_argument("--targets", nargs="+",
                    default=["neals_funnel_noncentered", "rosenbrock"])
    ap.add_argument("--dim", type=int, default=20)
    ap.add_argument("--schedule", type=str, default="tanh")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax import random

    from mcmc_tpu.targets import get_target
    from mcmc_tpu.tuning.chees import chees_run, run_chees_warmup
    from mcmc_tpu.diagnostics import ess_bulk_chunked

    print(f"devices: {jax.devices()}", file=sys.stderr)
    rows = []
    for tname in args.targets:
        t = get_target(tname, dim=args.dim)
        key = random.PRNGKey(args.seed)
        k_init, k_warm, k_samp = random.split(key, 3)
        init = (t.init_sampler(k_init, args.chains)
                if t.init_sampler is not None
                else random.normal(k_init, (args.chains, args.dim)) * 0.1
                ).astype(jnp.float32)

        for tuner in ("grid", "joint"):
            t0 = time.time()
            step, mass, pos, info = run_chees_warmup(
                "grahmc", t.log_prob_fn, None, init, k_warm,
                num_warmup=args.num_warmup, schedule_type=args.schedule,
                value_and_grad_fn=t.value_and_grad_fn, gamma_tuner=tuner)
            jax.block_until_ready(pos)
            warm_s = time.time() - t0
            # warmup gradient accounting: every warmup transition costs its
            # leapfrog count; the grid phase's probes add
            # len(grid) * (max_iter_step + gamma_samples_per_eval) * L more
            warm_grads = int(round(
                np.sum(np.asarray(info["mean_leapfrogs_history"]))
                * (args.num_warmup / max(len(
                    info["mean_leapfrogs_history"]), 1))))
            if info.get("gamma_tuner") == "grid" and tuner == "grid":
                # sequential grid: 6 gammas x (1000 DA + 150 ESJD) draws at
                # L=num_steps each (tuning/sequential.py defaults)
                warm_grads += 6 * (1000 + 150) * info["num_steps"]

            # identical sampling phase at each operating point
            skw = dict(inv_mass_matrix=mass,
                       value_and_grad_fn=t.value_and_grad_fn,
                       schedule_type=args.schedule,
                       gamma=info.get("gamma", 0.0),
                       steepness=info.get("steepness", 1.0))
            res = chees_run(k_samp, t.log_prob_fn, pos, step,
                            info["trajectory_length"], args.num_samples,
                            **skw)
            jax.block_until_ready(res.samples)
            t1 = time.time()
            res = chees_run(k_samp, t.log_prob_fn, pos, step,
                            info["trajectory_length"], args.num_samples,
                            halton_offset=args.num_samples, **skw)
            float(jnp.sum(res.final_state.position))
            samp_s = time.time() - t1
            ess = ess_bulk_chunked(res.samples, chain_chunk=1024,
                                   dim_chunk=4)
            ess_min = float(jnp.min(ess))
            n_grads = int(res.info["total_leapfrogs"])
            row = {
                "target": tname, "tuner": info.get("gamma_tuner", tuner),
                "requested": tuner,
                "step": round(float(step), 5),
                "T": round(float(info["trajectory_length"]), 4),
                "L": int(info["num_steps"]),
                "gamma": round(float(info.get("gamma", 0.0)), 4),
                "warmup_s": round(warm_s, 1),
                "warmup_grads": warm_grads,
                "sample_s": round(samp_s, 2),
                "ess_min": round(ess_min, 1),
                "sample_grads": n_grads,
                "ess_per_grad": round(ess_min / max(n_grads, 1), 8),
                "accept": round(float(res.accept_rate.mean()), 3),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)

    print("\n=== summary (joint vs grid) ===", file=sys.stderr)
    for tname in args.targets:
        g = next(r for r in rows if r["target"] == tname
                 and r["requested"] == "grid")
        j = next(r for r in rows if r["target"] == tname
                 and r["requested"] == "joint")
        ratio = j["ess_per_grad"] / max(g["ess_per_grad"], 1e-30)
        print(f"{tname}: joint/grid ESS-per-grad = {ratio:.2f}x, "
              f"warmup {g['warmup_s']:.0f}s -> {j['warmup_s']:.0f}s, "
              f"gamma {g['gamma']} -> {j['gamma']}", file=sys.stderr)


if __name__ == "__main__":
    main()
