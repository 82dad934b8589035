"""Pallas kernels: the fused trajectory transition and its target math."""

from mcmc_tpu.ops.padded_targets import (make_padded_vag, KERNEL_FAMILIES,
                                         resolve_backend)
from mcmc_tpu.ops.fused_trajectory import (
    make_fused_grahmc_step, make_debug_trajectory,
    PreparedDenseMetric, prepare_dense_metric,
)

__all__ = [
    "make_padded_vag", "KERNEL_FAMILIES", "resolve_backend",
    "make_fused_grahmc_step", "make_debug_trajectory",
    "PreparedDenseMetric", "prepare_dense_metric",
]
