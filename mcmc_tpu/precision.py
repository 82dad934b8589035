"""Mixed-precision policy.

The reference keeps positions/gradients in the position dtype and log-probs /
Hamiltonians in float64 (reference: samplers/HMC.py:74, samplers/GRAHMC.py:141,
samplers/NUTS.py:78). On an accelerator float64 costs far more than float32 (on
the H100, 67 vs 34 TFLOP/s outside the tensor cores, and no tensor-core path),
so the policy here is dtype-parametric:

- ``energy_dtype()`` returns float64 when ``jax_enable_x64`` is on (CPU validation
  runs, exact reference parity) and float32 otherwise (the accelerator path,
  validated by the statistical quality gates instead of bit-parity).
- Positions and gradients stay in the position dtype (float32 default).

The Metropolis test ``log u < min(0, H0 - H1)`` is a *difference* of energies, so
float32 accumulation is statistically adequate for the benchmark targets as long as
the non-finite-Hamiltonian reject guard is kept (it is, in every sampler).
"""

import jax
import jax.numpy as jnp
from jax import random

# Forced-rejection energy for non-finite Hamiltonians (reference: HMC.py:199,
# GRAHMC.py:328). Large enough that log_alpha is astronomically negative, small
# enough not to overflow float32.
ENERGY_OVERFLOW = 1e10


def x64_enabled() -> bool:
    return bool(jax.config.jax_enable_x64)


def energy_dtype():
    """Dtype for log-probs and Hamiltonians. float64 iff x64 is enabled."""
    return jnp.float64 if x64_enabled() else jnp.float32


def default_position_dtype():
    """Dtype for positions/momenta/gradients. Follows JAX default float."""
    return jnp.float64 if x64_enabled() else jnp.float32


def guard_energy(h):
    """Replace non-finite Hamiltonians with a huge finite value => forced reject."""
    return jnp.where(jnp.isfinite(h), h, jnp.asarray(ENERGY_OVERFLOW, dtype=h.dtype))


def accept_uniform(key, shape, dtype):
    """U(0, 1) draws for the Metropolis test ``log u < log_alpha``.

    ``random.uniform`` returns exactly 0 with probability 2^-23 per float32
    draw; log(0) = -inf then accepts ANY finite proposal, however bad, and
    a warmup of 10^7 draws meets such a zero about once — one chain jumps to
    |q| ~ 1e15 and poisons the learned metric. The draws are floored at the
    dtype's smallest normal, which leaves every other value bit-identical."""
    return random.uniform(key, shape, dtype=dtype,
                          minval=jnp.finfo(dtype).tiny)
