"""Chain-chunked (streaming) diagnostics for histories too large to process
in one program.

At the framework's own operating point — (S, 65536, D) histories, several GB —
a monolithic rank-normalized ESS program needs pooled sorts, FFT buffers and
rank gathers over the whole history at once, which overflows device memory
(see the `_DIM_CHUNK` note in diagnostics/__init__.py). The exact statistics, however, decompose over
chains:

- rank normalization pools ALL draws, so it is done ONCE per dim block on
  device (the sort-and-scatter scheme shared with the monolithic
  `_rank_normalize` — see its docstring);
- the Vehtari/Geyer ESS and split R-hat need only per-chain moments (chain
  means, unbiased chain variances, chain-averaged autocovariance), which are
  plain sums over chains.

So the streaming path rank-normalizes each dim block once, then accumulates
per-chain-chunk moments over slices of the precomputed z-scores, then combines
with the SAME `_ess_combine` / R-hat formulas as the monolithic path —
chunked == monolithic exactly (up to float summation order), which
`tests/test_streaming_diagnostics.py` asserts.

Nothing ever leaves the device: inputs can be (and should be) committed device
arrays; only the final (dim,) statistics are returned.
"""

import functools

import jax
import jax.numpy as jnp
from jax import lax

from mcmc_tpu.diagnostics.rhat_ess import (
    _autocovariance_fft, _ess_combine, _rank_normalize, _split_chains,
)

DEFAULT_CHAIN_CHUNK = 8192
DEFAULT_DIM_CHUNK = 8


# ---------------------------------------------------------------------------
# Mesh-sharded histories: per-dim sharded execution
#
# A GSPMD chain-sharded history cannot be chain-chunked from the host —
# every z[:, a:b] slice crosses the sharded axis and may gather or reshard
# the whole block. But every statistic here (rank-normalized ESS, R-hat,
# tail quantiles, moments) is INDEPENDENT PER DIMENSION, so the natural
# layout for diagnostics is dim-sharded, not chain-sharded: reshard one dim
# block (an all-to-all, the only collective), after which each
# device owns complete columns — pooled ranks, FFT autocovariance and
# cross-chain moments all run device-locally via the SAME monolithic
# per-column code as rhat_ess.py, so sharded == unsharded exactly.
# Per-device peak memory is bounded by dims_per_device columns
# (S x C x dims_per_device floats), set by dim_chunk exactly like the
# host-chunked path. (VERDICT r2 #4.)
# ---------------------------------------------------------------------------

def _mesh_axis_of_chains(samples):
    """(mesh, axis_names) when `samples` is committed chain-sharded on a
    NamedSharding mesh; (None, None) otherwise."""
    from jax.sharding import NamedSharding
    sh = getattr(samples, "sharding", None)
    if isinstance(sh, NamedSharding):
        spec = sh.spec
        if len(spec) > 1 and spec[1] is not None:
            return sh.mesh, spec[1]
    return None, None


@functools.lru_cache(maxsize=64)
def _sharded_stat_fn(mesh, axes, column_fn, out_rank):
    """Build (and cache) the jitted shard_map wrapper for one column
    statistic on one mesh. Caching matters: each distinct program costs a
    cold XLA compile, and a grid search calls the same estimators once per
    L at identical shapes."""
    from jax.sharding import PartitionSpec as P
    from mcmc_tpu.parallel import shard_map_fn

    return jax.jit(shard_map_fn(
        column_fn, mesh, in_specs=P(None, None, axes),
        out_specs=P(*([None] * (out_rank - 1)), axes)))


def _per_dim_sharded(samples, mesh, axis, column_fn, dims_per_device: int,
                     out_rank: int = 1):
    """Apply a per-column statistic ((S, C, dd_local) -> (..., dd_local))
    to a chain-sharded history by resharding dim blocks over `axis` of
    `mesh`; the statistic's trailing axis is the dim axis.

    Returns the concatenated (..., D) statistic (tiny; safe to gather).
    """
    axes = axis if isinstance(axis, tuple) else (axis,)
    n_dev = 1
    for a in axes:
        n_dev *= mesh.shape[a]
    stat = _sharded_stat_fn(mesh, axes, column_fn, out_rank)

    out = []
    for block, dd in _dim_blocks(samples, dims_per_device * n_dev):
        out.append(stat(block)[..., :dd])       # dim slice: shard-local
    return jnp.concatenate(out, axis=-1)


# Per-column statistics ARE the canonical monolithic estimators from
# rhat_ess.py — used by reference inside shard_map, so the "sharded ==
# unsharded exactly" invariant cannot drift (a fix to ess_bulk is
# automatically a fix to the mesh path).
from mcmc_tpu.diagnostics import rhat_ess as _rhat_ess      # noqa: E402

_col_ess_bulk = _rhat_ess.ess_bulk
_col_split_rhat = _rhat_ess.split_rhat
_col_ess_tail = _rhat_ess.ess_tail
_col_ess_mean = _rhat_ess.ess_mean


def _col_mean_sq(block):
    """Stacked (2, dd): pooled mean and sum of squared deviations. Both
    passes run device-locally (each device owns every draw of its dims)."""
    m = jnp.mean(block, axis=(0, 1))
    sq = jnp.sum((block - m[None, None, :]) ** 2, axis=(0, 1))
    return jnp.stack([m, sq])


@jax.jit
def _rank_z_block(block):
    """Pooled rank-normal z-scores for a whole (S, C, dd) dim block.

    Identical semantics (and implementation) to the monolithic
    `_rank_normalize`; jitted separately so each dim block compiles once at
    its own static shape.
    """
    return _rank_normalize(block)


@jax.jit
def _chunk_moments(z_chunk, center):
    """Per-chain-chunk accumulands from (S, c, dd) values.

    Returns sums over the chunk's 2c split chains of:
      (chain_var, acov (n, dd), mean, mean^2, chain var) and the count.
    Chain means are accumulated RELATIVE to `center` (a (dd,) estimate of
    the data location): chain variance, autocovariance and the variance of
    chain means are all shift-invariant, but the single-pass
    sum/sum-of-squares combination below cancels catastrophically in float32
    when |mean| >> sd — centering first makes it accurate for uncentered
    data (e.g. raw draws of a target with mean 1e4).
    """
    x = _split_chains(z_chunk) - center                   # (n, 2c, dd)
    n = x.shape[0]
    acov = _autocovariance_fft(x)                         # (n, 2c, dd)
    chain_var = acov[0] * n / (n - 1.0)                   # (2c, dd)
    zmean = jnp.mean(x, axis=0)                           # (2c, dd)
    zvar = jnp.var(x, axis=0, ddof=1)                     # (2c, dd)
    return (jnp.sum(chain_var, axis=0),
            jnp.sum(acov, axis=1),
            jnp.sum(zmean, axis=0),
            jnp.sum(zmean * zmean, axis=0),
            jnp.sum(zvar, axis=0),
            x.shape[1])


@jax.jit
def _first_chunk_mean(chunk):
    """Location estimate for centering: the first chunk's mean over ALL its
    draws x chains, (dd,). Averaging over every chain in the chunk (rather
    than chain 0 alone) keeps the float32 cancellation guard effective even
    when one chain is stuck or an outlier."""
    return jnp.mean(chunk, axis=(0, 1))


def _moments_over_chunks(get_chunk, S, C, chain_chunk):
    """Accumulate `_chunk_moments` sums over chain chunks.

    get_chunk(c0, c1) -> the (S, c1-c0, dd) values whose split-chain moments
    are wanted (z-scores, tail indicators, or raw draws).
    """
    center = _first_chunk_mean(get_chunk(0, min(chain_chunk, C)))
    sums = None
    m_total = 0
    for c0 in range(0, C, chain_chunk):
        cv, ac, zm, zm2, zv, m = _chunk_moments(
            get_chunk(c0, min(c0 + chain_chunk, C)), center)
        m_total += int(m)
        if sums is None:
            sums = [cv, ac, zm, zm2, zv]
        else:
            sums = [a + b for a, b in zip(sums, (cv, ac, zm, zm2, zv))]
    cv, ac, zm, zm2, zv = sums
    n = S // 2
    M = m_total
    mean_var = cv / M
    mean_acov = ac / M
    var_means = (zm2 - zm * zm / M) / (M - 1)
    return {
        "n": n, "M": M,
        "mean_var": mean_var, "mean_acov": mean_acov, "var_means": var_means,
        "W": zv / M,
    }


def _dim_blocks(samples, dim_chunk):
    """Yield (block, dd) with every block padded to exactly `dim_chunk` wide
    (a ragged trailing block repeats its last column, results sliced back to
    `dd`). All statistics here are per-dim independent, so padding cannot
    perturb real columns — and it keeps every chunked program at ONE
    compiled shape: each extra shape is another cold XLA compile, so the
    ragged tail would double them."""
    S, C, D = samples.shape
    for d0 in range(0, D, dim_chunk):
        block = samples[:, :, d0:d0 + dim_chunk]
        dd = block.shape[2]
        if dd < dim_chunk:
            pad = jnp.broadcast_to(block[:, :, -1:], (S, C, dim_chunk - dd))
            block = jnp.concatenate([block, pad], axis=2)
        yield block, dd


def _accumulate_block(block, chain_chunk):
    """Rank-normalize one dim block, then accumulate moments per chain chunk."""
    S, C, dd = block.shape
    z = _rank_z_block(block)
    return _moments_over_chunks(lambda a, b: z[:, a:b], S, C, chain_chunk)


def _ess_of_moments(mo):
    return _ess_combine(mo["mean_var"], mo["mean_acov"], mo["var_means"],
                        mo["n"], mo["M"])


def ess_bulk_chunked(samples, chain_chunk: int = DEFAULT_CHAIN_CHUNK,
                     dim_chunk: int = DEFAULT_DIM_CHUNK):
    """Bulk ESS of (S, C, D) samples, chunked over chains and dims.

    Exactly equal (up to summation order) to
    `mcmc_tpu.diagnostics.ess_bulk(samples)`, but never builds pooled-rank /
    FFT buffers for more than `chain_chunk` chains x `dim_chunk` dims at once.
    """
    samples = jnp.asarray(samples)
    S, C, D = samples.shape
    samples = samples[: 2 * (S // 2)]     # match _split_chains truncation
    mesh, axis = _mesh_axis_of_chains(samples)
    if mesh is not None:
        return _per_dim_sharded(samples, mesh, axis, _col_ess_bulk,
                                max(1, dim_chunk // 2))
    out = []
    for block, dd in _dim_blocks(samples, dim_chunk):
        out.append(_ess_of_moments(_accumulate_block(block, chain_chunk))[:dd])
    return jnp.concatenate(out)


def split_rhat_chunked(samples, chain_chunk: int = DEFAULT_CHAIN_CHUNK,
                       dim_chunk: int = DEFAULT_DIM_CHUNK):
    """Rank-normalized split R-hat (max of bulk and folded), chunked.

    Matches `mcmc_tpu.diagnostics.split_rhat(samples)` up to summation order.
    """
    samples = jnp.asarray(samples)
    S, C, D = samples.shape
    samples = samples[: 2 * (S // 2)]     # match _split_chains truncation
    S = samples.shape[0]
    mesh, axis = _mesh_axis_of_chains(samples)
    if mesh is not None:
        return _per_dim_sharded(samples, mesh, axis, _col_split_rhat,
                                max(1, dim_chunk // 2))
    out = []
    for block, dd in _dim_blocks(samples, dim_chunk):
        rhats = []
        for folded in (False, True):
            b = block
            if folded:
                med = jnp.median(block.reshape(S * C, -1), axis=0)
                b = jnp.abs(block - med)
            mo = _accumulate_block(b, chain_chunk)
            n, M = mo["n"], mo["M"]
            W = mo["W"]
            B = n * mo["var_means"]
            var_plus = (n - 1) / n * W + B / n
            rhats.append(jnp.sqrt(var_plus / W))
        out.append(jnp.maximum(*rhats)[:dd])
    return jnp.concatenate(out)


@jax.jit
def _tail_quantiles(block):
    """5%/95% quantiles of the pooled (already truncated) block, per dim."""
    S, C, dd = block.shape
    flat = block.reshape(S * C, dd)
    return (jnp.quantile(flat, 0.05, axis=0),
            jnp.quantile(flat, 0.95, axis=0))


def ess_tail_chunked(samples, chain_chunk: int = DEFAULT_CHAIN_CHUNK,
                     dim_chunk: int = DEFAULT_DIM_CHUNK):
    """Tail ESS (min ESS of the 5%/95% quantile indicator series), chunked.

    Matches `mcmc_tpu.diagnostics.ess_tail(samples)` up to summation order:
    the pooled quantiles are computed once per dim block (quantiles are
    order-free, so pre-split == post-split), then the indicator series'
    split-chain moments accumulate per chain chunk.
    """
    samples = jnp.asarray(samples)
    S, C, D = samples.shape
    samples = samples[: 2 * (S // 2)]     # match _split_chains truncation
    S = samples.shape[0]
    mesh, axis = _mesh_axis_of_chains(samples)
    if mesh is not None:
        return _per_dim_sharded(samples, mesh, axis, _col_ess_tail,
                                max(1, dim_chunk // 2))
    out = []
    for block, dd in _dim_blocks(samples, dim_chunk):
        q05, q95 = _tail_quantiles(block)
        esss = []
        for q in (q05, q95):
            mo = _moments_over_chunks(
                lambda a, b, q=q: (block[:, a:b] <= q).astype(block.dtype),
                S, C, chain_chunk)
            esss.append(_ess_of_moments(mo))
        out.append(jnp.minimum(*esss)[:dd])
    return jnp.concatenate(out)


def ess_mean_chunked(samples, chain_chunk: int = DEFAULT_CHAIN_CHUNK,
                     dim_chunk: int = DEFAULT_DIM_CHUNK):
    """ESS of the raw split draws (the 'mean' method), chunked.

    Matches `mcmc_tpu.diagnostics.ess_mean(samples)` up to summation order.
    """
    samples = jnp.asarray(samples)
    S, C, D = samples.shape
    samples = samples[: 2 * (S // 2)]
    S = samples.shape[0]
    mesh, axis = _mesh_axis_of_chains(samples)
    if mesh is not None:
        return _per_dim_sharded(samples, mesh, axis, _col_ess_mean,
                                max(1, dim_chunk // 2))
    out = []
    for block, dd in _dim_blocks(samples, dim_chunk):
        mo = _moments_over_chunks(lambda a, b: block[:, a:b], S, C,
                                  chain_chunk)
        out.append(_ess_of_moments(mo)[:dd])
    return jnp.concatenate(out)


@jax.jit
def _sum_count(chunk):
    """(sum, count) over draws x chains for a (S, c, dd) chunk."""
    return jnp.sum(chunk, axis=(0, 1)), chunk.shape[0] * chunk.shape[1]


@jax.jit
def _sq_dev_sum(chunk, mean):
    return jnp.sum((chunk - mean) ** 2, axis=(0, 1))


def _pooled_mean_sq_chunked(samples, chain_chunk, dim_chunk):
    """(mean, sum of squared deviations, count) over ALL pooled draws
    (untruncated), chunked. Two passes (mean, then squared deviations) so
    float32 accumulation stays exact enough at 10^7+ pooled draws — a
    single-pass sum-of-squares cancels catastrophically there.
    """
    S, C, D = samples.shape
    mesh, axis = _mesh_axis_of_chains(samples)
    if mesh is not None:
        ms = _per_dim_sharded(samples, mesh, axis, _col_mean_sq,
                              max(1, dim_chunk // 2), out_rank=2)
        return ms[0], ms[1], S * C
    means, sqs = [], []
    count = 0
    for block, dd in _dim_blocks(samples, dim_chunk):
        total, count = None, 0
        for c0 in range(0, C, chain_chunk):
            s, m = _sum_count(block[:, c0:c0 + chain_chunk])
            total = s if total is None else total + s
            count += int(m)
        mean = total / count
        sq = None
        for c0 in range(0, C, chain_chunk):
            d = _sq_dev_sum(block[:, c0:c0 + chain_chunk], mean)
            sq = d if sq is None else sq + d
        means.append(mean[:dd])
        sqs.append(sq[:dd])
    return jnp.concatenate(means), jnp.concatenate(sqs), count


def mcse_mean_chunked(samples, chain_chunk: int = DEFAULT_CHAIN_CHUNK,
                      dim_chunk: int = DEFAULT_DIM_CHUNK):
    """Monte Carlo standard error of the mean, chunked: sd / sqrt(ess_mean).

    Matches `mcmc_tpu.diagnostics.mcse_mean(samples)` up to summation order
    (the sd pools ALL draws including an odd trailing one, exactly like the
    monolithic version).
    """
    samples = jnp.asarray(samples)
    _, sq, count = _pooled_mean_sq_chunked(samples, chain_chunk, dim_chunk)
    sd = jnp.sqrt(sq / (count - 1))
    return sd / jnp.sqrt(ess_mean_chunked(samples, chain_chunk, dim_chunk))


def compute_diagnostics_chunked(samples,
                                chain_chunk: int = DEFAULT_CHAIN_CHUNK,
                                dim_chunk: int = DEFAULT_DIM_CHUNK) -> dict:
    """Full gate-grade diagnostics dict for histories too large to process
    monolithically — same keys as `mcmc_tpu.diagnostics.compute_diagnostics`
    (reference arviz parity, run_benchmarks.py:161-195), every statistic
    computed over ALL chains via the chain+dim-chunked estimators. The input
    can (and should) be a committed device array; nothing but the final
    (dim,)-sized statistics leaves the device.
    """
    import numpy as np

    samples = jnp.asarray(samples)
    rhat = np.asarray(split_rhat_chunked(samples, chain_chunk, dim_chunk))
    bulk = np.asarray(ess_bulk_chunked(samples, chain_chunk, dim_chunk))
    tail = np.asarray(ess_tail_chunked(samples, chain_chunk, dim_chunk))

    # one shared mean/sq sweep feeds both the summary moments and the MCSE
    # (mcse = sd_ddof1 / sqrt(ess_mean); summary sd is ddof=0 like jnp.std)
    mean_j, sq, count = _pooled_mean_sq_chunked(samples, chain_chunk,
                                                dim_chunk)
    mcse = np.asarray(
        jnp.sqrt(sq / (count - 1))
        / jnp.sqrt(ess_mean_chunked(samples, chain_chunk, dim_chunk)))
    mean = np.asarray(mean_j)
    std = np.asarray(jnp.sqrt(sq / count))

    return {
        "rhat_max": float(np.max(rhat)),
        "rhat_mean": float(np.mean(rhat)),
        "ess_bulk_min": float(np.min(bulk)),
        "ess_bulk_mean": float(np.mean(bulk)),
        "ess_tail_min": float(np.min(tail)),
        "ess_tail_mean": float(np.mean(tail)),
        "mean_estimate": mean,
        "std_estimate": std,
        "summary": {
            "mean": mean,
            "sd": std,
            "mcse_mean": mcse,
            "ess_bulk": bulk,
            "ess_tail": tail,
            "r_hat": rhat,
        },
    }
