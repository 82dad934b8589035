"""Convergence diagnostics as batched on-device reductions.

The reference delegates R-hat / ESS / MCSE to arviz on the host
(reference run_benchmarks.py:161-195); here they are reimplemented as pure-jnp
batched reductions following Vehtari, Gelman, Simpson, Carpenter & Bürkner
(2021), "Rank-normalization, folding, and localization: An improved R-hat for
assessing convergence of MCMC":

- split chains in half,
- rank-normalize with the (r - 3/8)/(S + 1/4) normal-scores transform,
- R-hat = sqrt(var_plus / W) on the z-scores, reported as the max of the bulk
  and folded (|x - median|) statistics,
- ESS via FFT autocovariance + Geyer's initial monotone positive sequence,
- bulk ESS on rank-normalized split chains, tail ESS as the min ESS of the
  5%/95% quantile indicator series, mean-ESS (raw draws) for MCSE.

Everything is vectorized over the trailing ``dim`` axis and jit-compatible, so
diagnostics for 10^5-chain runs never leave the device: the only cross-chain
ops in the whole framework are the reductions here, which XLA lowers to
collectives when the chain axis is sharded over a mesh.

Sample layout convention matches the framework ABI: (num_samples, n_chains, dim).
"""

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.special import ndtri


def _split_chains(x):
    """(n, m, d) -> (n//2, 2m, d): split each chain into halves."""
    n = x.shape[0]
    half = n // 2
    x = x[: 2 * half]
    return jnp.concatenate([x[:half], x[half:]], axis=1)


def _z_from_rank2(k, N):
    """z = ndtri((rank - 3/8) / (N + 1/4)) from k = 2*rank (integer).

    Evaluated two-sided so it stays finite in float32 at N ~ 10^7+: near
    u = 1 the naive ratio rounds to exactly 1.0 (ndtri -> +inf); instead the
    upper tail is computed from the exact integer complement 2N - k.
    u     = (k - 0.75)   / (2N + 0.5)
    1 - u = (2N - k + 1.25) / (2N + 0.5)
    """
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    denom = 2.0 * N + 0.5
    kf = k.astype(dtype)
    hkf = (2 * N - k).astype(dtype)
    z_low = ndtri((kf - 0.75) / denom)
    z_high = -ndtri((hkf + 1.25) / denom)
    return jnp.where(k <= N, z_low, z_high)


def _rank_normalize(x):
    """Normal-scores transform of pooled average ranks, per trailing dim.

    Average ranks for ties (exact match with scipy.stats.rankdata
    method='average'): in sort order each element's tie run [lo, e] is found
    with forward/backward max-scans over run boundaries; average 1-based rank
    = (lo + e + 2) / 2.  The sort is a two-operand `lax.sort` carrying the
    original index (`searchsorted` would lower to binary-search gathers);
    the inverse permutation is one scatter with unique indices. (Inverting
    it by a second sort keyed on the permutation is rewritten by XLA's GPU
    permutation-sort simplifier into a scatter that fails HLO verification
    inside a shard_map'd program — jax 0.9.0.)
    z = ndtri((rank - 3/8) / (S + 1/4)), evaluated tail-safely (_z_from_rank2).
    """
    n, m, d = x.shape
    N = n * m
    flat = x.reshape(N, d)
    idx = lax.broadcasted_iota(jnp.int32, (N, d), 0)
    srt, perm = lax.sort((flat, idx), dimension=0, num_keys=1)

    is_new = jnp.concatenate(
        [jnp.ones((1, d), bool), srt[1:] != srt[:-1]], axis=0)
    lo = lax.cummax(jnp.where(is_new, idx, 0), axis=0)
    is_end = jnp.concatenate([is_new[1:], jnp.ones((1, d), bool)], axis=0)
    e = -lax.cummax(jnp.where(is_end, -idx, -(N - 1)), axis=0, reverse=True)
    k2 = lo + e + 2                  # = 2 * average_rank (1-based)

    z_sorted = _z_from_rank2(k2, N).astype(flat.dtype)
    cols = lax.broadcasted_iota(jnp.int32, (N, d), 1)
    z = jnp.zeros_like(z_sorted).at[perm, cols].set(z_sorted,
                                                    unique_indices=True)
    return z.reshape(n, m, d)


def _rhat_classic(x):
    """Classic split-R-hat on (n, m, d) (already split/transformed): (d,)."""
    n = x.shape[0]
    chain_means = jnp.mean(x, axis=0)                      # (m, d)
    chain_vars = jnp.var(x, axis=0, ddof=1)                # (m, d)
    W = jnp.mean(chain_vars, axis=0)                       # (d,)
    B = n * jnp.var(chain_means, axis=0, ddof=1)           # (d,)
    var_plus = (n - 1) / n * W + B / n
    return jnp.sqrt(var_plus / W)


@jax.jit
def split_rhat(samples):
    """Rank-normalized split R-hat, max of bulk and folded (Vehtari et al. 2021).

    Args:
        samples: (num_samples, n_chains, dim)
    Returns:
        (dim,) R-hat per dimension.
    """
    x = _split_chains(jnp.asarray(samples))
    z_bulk = _rank_normalize(x)
    folded = jnp.abs(x - jnp.median(x.reshape(-1, x.shape[-1]), axis=0))
    z_tail = _rank_normalize(folded)
    return jnp.maximum(_rhat_classic(z_bulk), _rhat_classic(z_tail))


def _autocovariance_fft(x):
    """Biased autocovariance per chain via FFT. x: (n, m, d) -> (n, m, d)."""
    n = x.shape[0]
    xc = x - jnp.mean(x, axis=0, keepdims=True)
    # Pad to >= 2n for linear (non-circular) autocorrelation.
    size = 1 << (2 * n - 1).bit_length()
    f = jnp.fft.rfft(xc, n=size, axis=0)
    acov = jnp.fft.irfft(f * jnp.conj(f), n=size, axis=0)[:n]
    return acov.real / n


def _ess_combine(mean_var, mean_acov, var_chain_means, n, total_chains):
    """Combine per-chain moments into ESS (Geyer initial monotone sequence).

    mean_var: (d,) mean over chains of unbiased per-chain variances (W).
    mean_acov: (n, d) mean over chains of biased autocovariances.
    var_chain_means: (d,) ddof=1 variance over chains of per-chain means.
    Shared by the monolithic `_ess_core` and the chain-chunked streaming path
    (diagnostics/streaming.py) so chunked == monolithic exactly.
    """
    d = mean_acov.shape[-1]
    var_plus = mean_var * (n - 1.0) / n + var_chain_means

    # rho_t = 1 - (W - mean acov_t) / var_plus
    rho = 1.0 - (mean_var[None, :] - mean_acov) / var_plus[None, :]
    rho = rho.at[0].set(1.0)

    # Geyer pairs P_k = rho_{2k} + rho_{2k+1}
    n_pairs = n // 2
    P = rho[: 2 * n_pairs].reshape(n_pairs, 2, d).sum(axis=1)   # (K, d)
    # Initial positive sequence: keep the longest prefix with P > 0, always
    # keeping k = 0 (Stan/arviz behavior).
    pos = P > 0.0
    pos = pos.at[0].set(True)
    valid = jnp.cumprod(pos.astype(jnp.int32), axis=0).astype(bool)
    # Initial monotone sequence: running minimum over the valid prefix.
    P_mono = lax.associative_scan(jnp.minimum, jnp.where(valid, P, jnp.inf), axis=0)
    P_used = jnp.where(valid, P_mono, 0.0)
    tau = jnp.maximum(-1.0 + 2.0 * jnp.sum(P_used, axis=0),
                      1.0 / jnp.log10(n * total_chains + 10.0))
    ess = n * total_chains / tau
    # Guard degenerate (zero-variance) dims.
    return jnp.where(var_plus > 0, ess,
                     jnp.asarray(float(n * total_chains), ess.dtype))


def _ess_core(x):
    """ESS of (n, m, d) split chains (Geyer initial monotone sequence): (d,)."""
    n, m, d = x.shape
    acov = _autocovariance_fft(x)                           # (n, m, d)
    chain_var = acov[0] * n / (n - 1.0)                     # (m, d) ~ s^2_m
    mean_var = jnp.mean(chain_var, axis=0)                  # (d,) = W
    mean_acov = jnp.mean(acov, axis=1)                      # (n, d)
    var_chain_means = jnp.var(jnp.mean(x, axis=0), axis=0, ddof=1)
    return _ess_combine(mean_var, mean_acov, var_chain_means, n, m)


@jax.jit
def ess_bulk(samples):
    """Bulk ESS: ESS of rank-normalized split chains. (num_samples, m, d) -> (d,)."""
    x = _split_chains(jnp.asarray(samples))
    return _ess_core(_rank_normalize(x))


@jax.jit
def ess_tail(samples):
    """Tail ESS: min ESS of the 5% and 95% quantile indicator series."""
    x = _split_chains(jnp.asarray(samples))
    flat = x.reshape(-1, x.shape[-1])
    q05 = jnp.quantile(flat, 0.05, axis=0)
    q95 = jnp.quantile(flat, 0.95, axis=0)
    ess05 = _ess_core((x <= q05).astype(flat.dtype))
    ess95 = _ess_core((x <= q95).astype(flat.dtype))
    return jnp.minimum(ess05, ess95)


@jax.jit
def ess_mean(samples):
    """ESS of the raw split draws (the 'mean' method), used for MCSE."""
    return _ess_core(_split_chains(jnp.asarray(samples)))


@jax.jit
def mcse_mean(samples):
    """Monte Carlo standard error of the mean: sd / sqrt(ess_mean)."""
    x = jnp.asarray(samples)
    flat = x.reshape(-1, x.shape[-1])
    sd = jnp.std(flat, axis=0, ddof=1)
    return sd / jnp.sqrt(ess_mean(x))
