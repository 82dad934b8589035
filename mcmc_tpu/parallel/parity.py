"""Multi-device parity checks: every mesh path against its one-device run.

Four mechanisms, each compared with what it must reproduce:

- shard_map paths (the fused kernel is opaque to GSPMD; the persistent-NUTS
  machine and tempering are shard_mapped too): each device's stream is
  fold_in(key, axis_index), so device 0's shard of an n-device run must
  equal a one-device-mesh run over shard 0's chains with the same key (same
  local shapes, same folded key) — bitwise where the compiler makes the same
  choices for both programs;
- GSPMD: the XLA sampler on chain-sharded inputs against the same call on
  unsharded inputs (partitionable threefry: identical random streams; the
  per-chain reductions may be vectorized in another order);
- collective diagnostics: R-hat/ESS (compute_diagnostics, per-dim-sharded
  path) and sliced W2 of a chain-sharded history against the unsharded one;
- SMC: sharded and unsharded runs on one fixed ladder must agree on log-Z
  to Monte-Carlo error (their per-device streams differ), bounded by 3x
  the largest gap measured over seeds at that size.

Each function returns one record per check ({"check", "max_rel_diff",
"bound", "bitwise", "ok", ...}); `mesh_checks` lists the four groups and
`run_mesh_parity` runs them all. Used by
`chip_smoke.py --multi` (four GPUs), `__graft_entry__.dryrun_multichip`
(virtual CPU devices) and the tests.
"""

from typing import Callable, Dict, List, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import random

# f32 state after a few transitions: relative agreement to a few ulps
F32_REL_TOL = 1e-5
# |log Z sharded - log Z unsharded| on smc_parity's fixed 8-stage ladder:
# 3x the largest gap over 20 seeds at the headline size (4 devices, 50D
# standard normal, 65,536 particles: largest gap 0.146, per-run sd 0.039 /
# 0.040 sharded / unsharded). Smaller runs pass their own reading.
SMC_LOGZ_BOUND = 0.44


def _rel_diff(a, b) -> float:
    """max |a - b| / (1 + |b|) over all entries (host numpy, f64)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


def _record(check: str, diff: float, bound: float, **extra) -> Dict:
    return {"check": check, "max_rel_diff": diff, "bound": bound,
            "bitwise": diff == 0.0, "ok": bool(diff <= bound), **extra}


def shard_map_parity(mesh, target, init_pos, backend: str = "auto",
                     num_samples: int = 4, num_steps: int = 8) -> List[Dict]:
    """Shard 0 of each shard_map path on `mesh` against a one-device run.

    backend: the trajectory backend for the fused-kernel and tempering
    paths ('auto', 'pallas' or 'interpret'; ops/padded_targets).
    """
    from mcmc_tpu.ops.padded_targets import resolve_backend
    from mcmc_tpu.parallel import make_mesh
    from mcmc_tpu.parallel.fused_sharded import (grahmc_run_sharded,
                                                 nuts_persistent_run_sharded,
                                                 tempered_run_sharded)
    from mcmc_tpu.samplers.grahmc import tanh_schedule

    n_dev = mesh.devices.size
    n_chains, dim = init_pos.shape
    per_dev = n_chains // n_dev
    mesh1 = make_mesh(1)
    shard0 = jnp.asarray(init_pos)[:per_dev]
    kernel = resolve_backend(backend, target.value_and_grad_fn)
    out = []

    def pair(name, run, key, collect):
        full = run(key, init_pos, mesh)
        one = run(key, shard0, mesh1)
        diff = max(_rel_diff(full.samples[:, :collect], one.samples),
                   _rel_diff(full.final_state.position[:per_dev],
                             one.final_state.position))
        out.append(_record(name, diff, F32_REL_TOL,
                           finite=bool(jnp.all(jnp.isfinite(full.samples)))))

    if kernel != "xla":
        gr_kw = dict(step_size=0.1, num_steps=num_steps, gamma=1.0,
                     steepness=0.5, num_samples=num_samples, burn_in=2,
                     friction_schedule=tanh_schedule,
                     collect_chains_per_device=2,
                     backend=kernel)
        pair("shard_map/grahmc-kernel",
             lambda k, p, m: grahmc_run_sharded(k, target, p, m, **gr_kw),
             random.PRNGKey(2), 2)

    nuts_kw = dict(step_size=0.2, num_samples=3, steps_per_sample=8,
                   burn_in_steps=8, collect_chains_per_device=2)
    dense = jnp.eye(dim, dtype=jnp.float32) * 1.5
    for name, extra in (("shard_map/persistent-nuts", {}),
                        ("shard_map/persistent-nuts-multinomial",
                         {"proposal_scheme": "multinomial"}),
                        ("shard_map/persistent-nuts-dense",
                         {"inv_mass_matrix": dense})):
        pair(name, lambda k, p, m, extra=extra: nuts_persistent_run_sharded(
            k, target, p, m, **nuts_kw, **extra), random.PRNGKey(3), 2)

    temp_kw = dict(step_size=0.1, num_steps=num_steps,
                   num_samples=num_samples, n_temps=3,
                   betas=jnp.asarray([1.0, 0.3, 0.08], jnp.float32),
                   backend=kernel)
    pair("shard_map/tempering",
         lambda k, p, m: tempered_run_sharded(k, target, p, m, **temp_kw),
         random.PRNGKey(8), per_dev)
    return out


def gspmd_parity(mesh, target, init_pos, num_samples: int = 4,
                 num_steps: int = 8) -> List[Dict]:
    """The XLA GRAHMC sampler on chain-sharded inputs against unsharded."""
    from mcmc_tpu.parallel import shard_chains
    from mcmc_tpu.samplers import grahmc_run
    from mcmc_tpu.samplers.grahmc import tanh_schedule

    def run(pos):
        return grahmc_run(random.PRNGKey(1), target.log_prob_fn, pos, 0.1,
                          num_steps, 1.0, 0.5, num_samples,
                          friction_schedule=tanh_schedule,
                          value_and_grad_fn=target.value_and_grad_fn,
                          collect_chains=8, backend="xla")

    sharded = run(shard_chains(init_pos, mesh))
    plain = run(jnp.asarray(init_pos))
    diff = max(_rel_diff(sharded.samples, plain.samples),
               _rel_diff(sharded.final_state.position,
                         plain.final_state.position))
    return [_record("gspmd/grahmc-xla", diff, F32_REL_TOL)]


def diagnostics_parity(mesh, n_chains: int, dim: int,
                       n_draws: int = 64) -> List[Dict]:
    """R-hat/ESS and sliced W2 of a chain-sharded history (collectives over
    the mesh) against the same history on one device."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mcmc_tpu.diagnostics import compute_diagnostics, compute_sliced_w2
    from mcmc_tpu.parallel import CHAIN_AXIS

    hist = random.normal(random.PRNGKey(11), (n_draws, n_chains, dim),
                         jnp.float32)
    hist_s = jax.device_put(hist, NamedSharding(mesh, P(None, CHAIN_AXIS,
                                                        None)))
    d_s = compute_diagnostics(hist_s)
    d_u = compute_diagnostics(hist)
    keys = ("rhat_max", "rhat_mean", "ess_bulk_min", "ess_tail_min")
    diff = max(_rel_diff(d_s[k], d_u[k]) for k in keys)
    w2_kw = dict(n_reference=4096, n_projections=32, key=random.PRNGKey(12))
    w2_s = compute_sliced_w2(hist_s, "standard_normal", dim, **w2_kw)
    w2_u = compute_sliced_w2(hist, "standard_normal", dim, **w2_kw)
    return [_record("collectives/rhat-ess", diff, F32_REL_TOL,
                    rhat_max=d_s["rhat_max"], ess_bulk_min=d_s["ess_bulk_min"]),
            _record("collectives/sliced-w2", _rel_diff(w2_s, w2_u),
                    F32_REL_TOL, w2=float(w2_s))]


def smc_parity(mesh, target, n_particles: int, move_backend: str = "auto",
               bound: float = SMC_LOGZ_BOUND) -> List[Dict]:
    """Sharded SMC against unsharded on one fixed ladder: identical stage
    count, globally normalized weights, and log-Z gap within `bound`, which
    is 3x the largest gap measured over seeds at that size (the two runs'
    per-device streams differ, so their gap is Monte-Carlo error)."""
    from mcmc_tpu.parallel.fused_sharded import smc_run_sharded
    from mcmc_tpu.samplers.smc import smc_run

    kw = dict(n_particles=n_particles, dim=target.dim, step_size=0.3,
              num_steps=4, move_steps=2, base_scale=2.0,
              betas=jnp.linspace(0.2, 1.0, 8), max_stages=30,
              value_and_grad_fn=target.value_and_grad_fn,
              move_backend=move_backend)
    sres = smc_run_sharded(random.PRNGKey(9), target.log_prob_fn, mesh, **kw)
    uref = smc_run(random.PRNGKey(9), target.log_prob_fn, **kw)
    d_logz = abs(float(sres.log_Z) - float(uref.log_Z))
    same_ladder = (int(sres.info["n_stages"]) == int(uref.info["n_stages"]))
    weight_sum = float(jnp.exp(sres.log_weights).sum())
    rec = _record("smc/log-z", d_logz, bound,
                  log_z_sharded=float(sres.log_Z),
                  log_z_unsharded=float(uref.log_Z),
                  same_ladder=same_ladder, weight_sum=weight_sum)
    rec["ok"] = rec["ok"] and same_ladder and abs(weight_sum - 1.0) < 1e-4
    return [rec]


def mesh_checks(mesh, n_chains: int, dim: int, backend: str = "auto",
                smc_particles: int = None, smc_bound: float = SMC_LOGZ_BOUND
                ) -> List[Tuple[str, Callable[[], List[Dict]]]]:
    """The four check groups above as (name, run) pairs, on `mesh` for the
    dim-D Neal's funnel (SMC on the standard normal, whose log-Z is 0),
    n_chains chains in all. Each run() returns its records."""
    from mcmc_tpu.parallel import shard_chains
    from mcmc_tpu.targets import neals_funnel, standard_normal

    target = neals_funnel(dim)
    init = target.init_sampler(random.PRNGKey(0), n_chains).astype(
        jnp.float32)
    return [
        ("shard_map", lambda: shard_map_parity(
            mesh, target, shard_chains(init, mesh), backend=backend)),
        ("gspmd", lambda: gspmd_parity(mesh, target, init)),
        ("collectives", lambda: diagnostics_parity(mesh, n_chains, dim)),
        ("smc", lambda: smc_parity(mesh, standard_normal(dim),
                                   smc_particles or n_chains,
                                   move_backend=backend, bound=smc_bound)),
    ]


def run_mesh_parity(mesh, n_chains: int, dim: int, backend: str = "auto",
                    smc_particles: int = None,
                    smc_bound: float = SMC_LOGZ_BOUND) -> List[Dict]:
    """Every record of every group of `mesh_checks`."""
    return [rec for _, run in mesh_checks(mesh, n_chains, dim, backend,
                                          smc_particles, smc_bound)
            for rec in run()]
