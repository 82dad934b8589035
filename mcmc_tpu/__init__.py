"""mcmc_tpu — a batched MCMC framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the GRAHMC research
codebase (reference: Chuxuan-a/mcmc): four samplers (RWMH, HMC, NUTS, GRAHMC with five
friction schedules), Stan-style adaptive warmup (dual averaging + windowed diagonal
mass-matrix adaptation + sequential ESJD friction tuning), analytic target
distributions with exact reference samplers, on-device diagnostics (rank-normalized
split R-hat, bulk/tail ESS, MCSE, Bonferroni z-tests, Sliced Wasserstein-2), and a
fixed-budget benchmarking CLI with two-tier quality gates.

Design principles:
- Chain parallelism is the scaling axis: every sampler is batched over a leading
  ``(n_chains, n_dim)`` axis and shards over a ``jax.sharding.Mesh`` with zero
  collectives in the hot loop.
- All hot loops are on-device ``lax.scan``s; on a GPU the HMC/GRAHMC trajectory
  runs as one fused Pallas kernel compiled through Triton (``mcmc_tpu.ops``) that
  keeps the leapfrog loop, target gradient, friction damping and Metropolis
  accept on the SM.
- Targets carry hand-derived analytic gradients (checked against ``jax.grad`` to
  float64 tolerance) so kernels never need autodiff inside Pallas.
- Mixed precision policy: positions/gradients in position dtype (float32 by default),
  log-probs and Hamiltonians in the energy dtype (float64 when x64 is enabled — the
  reference's policy — else float32 on the accelerator, validated by statistical
  gates).
"""

from mcmc_tpu import precision
from mcmc_tpu.targets import (TargetDistribution, get_target,
                              get_reference_sampler, has_reference_sampler,
                              unconstrain_target)

__version__ = "0.1.0"

__all__ = [
    "precision",
    "TargetDistribution",
    "get_target",
    "get_reference_sampler",
    "has_reference_sampler",
]
