"""Fixed-budget benchmark pipeline: warmup -> sample -> diagnose -> gate.

Drives the reference's exact CLI contract (flags, result-JSON/CSV schema,
incremental save/resume, trajectory-length grid search, convergence tracking —
reference run_benchmarks.py) on the batched JAX sampler stack.
"""

from mcmc_tpu.benchmark.runner import (
    get_log_checkpoints,
    run_single_benchmark_with_L,
    run_trajectory_length_grid_search,
    run_all_benchmarks,
    save_result_incremental,
    print_summary,
    ALL_TARGET_NAMES,
)

__all__ = [
    "get_log_checkpoints",
    "run_single_benchmark_with_L",
    "run_trajectory_length_grid_search",
    "run_all_benchmarks",
    "save_result_incremental",
    "print_summary",
    "ALL_TARGET_NAMES",
]
