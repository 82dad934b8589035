"""Multi-device chain-parallel sampling (e.g. four GPUs of one host).

Chains are the only parallel axis in MCMC (SURVEY.md §2), so scaling out is
pure data parallelism over a 1-D `jax.sharding.Mesh`: every device advances
its chain shard independently — zero collectives in the sampling loop — and
only the final diagnostics reductions cross devices.

Three ways to go multi-device, shown below:

1. CLI: `python run_benchmarks.py ... --mesh auto` (GSPMD for the XLA
   samplers, explicit shard_map for the fused trajectory kernel).
2. GSPMD: pass mesh-sharded positions to any XLA-path sampler; the
   partitioner splits the whole program with no code changes
   (`mcmc_tpu.parallel.shard_chains`).
3. shard_map: the fused kernel is opaque to GSPMD, so
   `mcmc_tpu.parallel.fused_sharded` wraps it per device
   (`grahmc_run_sharded`); `nuts_persistent_run_sharded` runs one
   persistent-NUTS machine per device the same way.

The ChEES trajectory tuner composes with all of this: `--trajectory-tuner
chees --mesh N` runs its warmup windows and jittered sampling shard_mapped
(the criterion's cross-chain moments psum over the chain axis) — see
examples/chees_tuning.py for the single-device walkthrough.

Run on a multi-GPU host (the chain count must be divisible by the device
count):

    python examples/multichip_sampling.py

Without multiple accelerators, `JAX_PLATFORMS=cpu` demonstrates it on an
8-device virtual CPU mesh (the same code path the test suite validates),
with the fused kernel under the Pallas interpreter.

Multi-host runs: call `mcmc_tpu.parallel.distributed.initialize()` first
(one process per host; the chain mesh spans all hosts — see
parallel/distributed.py).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# CPU demonstration: 8 virtual devices. XLA parses XLA_FLAGS once at first
# backend creation, so this must be set BEFORE importing jax (it only
# affects the CPU platform).
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

import jax.numpy as jnp
import jax.random as random

from mcmc_tpu import get_target
from mcmc_tpu.diagnostics import compute_diagnostics
from mcmc_tpu.ops import resolve_backend
from mcmc_tpu.parallel import make_mesh, shard_chains
from mcmc_tpu.parallel.fused_sharded import (
    grahmc_run_sharded, nuts_persistent_run_sharded,
)
from mcmc_tpu.samplers import nuts_run


def main():
    n_dev = len(jax.devices())
    if n_dev == 1:
        print("note: single device — the mesh code below is identical at "
              "any device count; run JAX_PLATFORMS=cpu for an 8-device demo")
    mesh = make_mesh(n_dev)
    dim = 20
    target = get_target("neals_funnel", dim=dim)
    # the compiled kernel on a GPU; elsewhere the same kernel under the
    # Pallas interpreter, at a demonstration size
    compiled = resolve_backend("auto", target.value_and_grad_fn) == "pallas"
    chains_per_device = 512 if compiled else 8
    n_chains = chains_per_device * n_dev
    init = target.init_sampler(random.PRNGKey(0), n_chains)
    print(f"{n_dev} devices x {chains_per_device} chains, {dim}D funnel")

    # --- fused GRAHMC kernel, one shard per device -----------------------
    res = grahmc_run_sharded(
        random.PRNGKey(1), target, init, mesh,
        step_size=0.05, num_steps=16, gamma=1.0, steepness=0.5,
        num_samples=256, burn_in=128, collect_chains_per_device=4,
        backend="pallas" if compiled else "interpret")
    d = compute_diagnostics(res.samples)
    print(f"GRAHMC sharded: accept={float(res.accept_rate.mean()):.3f} "
          f"rhat_max={d['rhat_max']:.3f} "
          f"divergences={int(res.info['total_divergences'])}")

    # --- persistent-NUTS machine, one per device --------------------------
    nres = nuts_persistent_run_sharded(
        random.PRNGKey(2), target, init, mesh,
        step_size=0.1, num_samples=32, steps_per_sample=32,
        burn_in_steps=64, collect_chains_per_device=4)
    print(f"NUTS sharded: accept={float(nres.accept_rate.mean()):.3f} "
          f"useful leapfrogs={int(nres.info['n_leapfrogs']):,} "
          f"mean depth={float(nres.info['mean_tree_depth'].mean()):.2f}")

    # --- GSPMD: shard the inputs, run the unmodified XLA sampler ---------
    sharded_init = shard_chains(init, mesh)
    xres = nuts_run(random.PRNGKey(3), target.log_prob_fn, sharded_init,
                    step_size=0.1, num_samples=64, burn_in=32,
                    value_and_grad_fn=target.value_and_grad_fn)
    print(f"NUTS GSPMD: accept={float(xres.accept_rate.mean()):.3f} "
          f"(positions stayed sharded: "
          f"{xres.final_state.position.sharding})")


if __name__ == "__main__":
    main()
