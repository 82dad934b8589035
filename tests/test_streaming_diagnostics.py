"""Chain-chunked streaming diagnostics must equal the monolithic reductions
(VERDICT r1 item 8: full-history ESS at 65k chains without host transfer)."""

import numpy as np
import jax.numpy as jnp
import jax.random as random

from mcmc_tpu.diagnostics import (
    ess_bulk, split_rhat, ess_bulk_chunked, split_rhat_chunked,
)


def _history(key, S=64, C=24, D=5):
    """Correlated synthetic history: AR(1) chains with per-chain offsets."""
    k1, k2 = random.split(key)
    noise = random.normal(k1, (S, C, D))
    x = [noise[0]]
    for t in range(1, S):
        x.append(0.7 * x[-1] + noise[t])
    x = jnp.stack(x)
    offsets = 0.2 * random.normal(k2, (1, C, D))
    return x + offsets


def test_ess_bulk_chunked_matches_monolithic():
    h = _history(random.PRNGKey(0))
    full = np.asarray(ess_bulk(h))
    # (7,3): ragged tails on both axes; (24,5): single chunk == the
    # monolithic graph shape. Even chunking (8,2) and the exhaustive (1,1)
    # add no new code path beyond the ragged case (dropped: each config
    # compiles its own block shapes, ~10s each on one CPU core).
    for chain_chunk, dim_chunk in ((24, 5), (7, 3)):
        chunked = np.asarray(ess_bulk_chunked(h, chain_chunk=chain_chunk,
                                              dim_chunk=dim_chunk))
        np.testing.assert_allclose(chunked, full, rtol=1e-6,
                                   err_msg=f"chunks=({chain_chunk},{dim_chunk})")


def test_split_rhat_chunked_matches_monolithic():
    h = _history(random.PRNGKey(1))
    full = np.asarray(split_rhat(h))
    for chain_chunk, dim_chunk in ((24, 5), (8, 2), (7, 3)):
        chunked = np.asarray(split_rhat_chunked(h, chain_chunk=chain_chunk,
                                                dim_chunk=dim_chunk))
        np.testing.assert_allclose(chunked, full, rtol=1e-6,
                                   err_msg=f"chunks=({chain_chunk},{dim_chunk})")


def test_chunked_on_odd_sample_count():
    """Odd S exercises the split-chain truncation path."""
    h = _history(random.PRNGKey(2), S=63, C=10, D=3)
    np.testing.assert_allclose(np.asarray(ess_bulk_chunked(h, 4, 2)),
                               np.asarray(ess_bulk(h)), rtol=1e-6)


def test_ess_tail_chunked_matches_monolithic():
    from mcmc_tpu.diagnostics import ess_tail, ess_tail_chunked
    h = _history(random.PRNGKey(3))
    full = np.asarray(ess_tail(h))
    for cc, dc in ((8, 2), (7, 3)):
        np.testing.assert_allclose(
            np.asarray(ess_tail_chunked(h, chain_chunk=cc, dim_chunk=dc)),
            full, rtol=1e-5, err_msg=f"chunks=({cc},{dc})")


def test_mcse_and_mean_ess_chunked_match_monolithic():
    from mcmc_tpu.diagnostics import (ess_mean, ess_mean_chunked, mcse_mean,
                                      mcse_mean_chunked)
    # odd S exercises the untruncated-sd / truncated-ESS split
    h = _history(random.PRNGKey(4), S=63, C=10, D=3)
    np.testing.assert_allclose(np.asarray(ess_mean_chunked(h, 4, 2)),
                               np.asarray(ess_mean(h)), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(mcse_mean_chunked(h, 4, 2)),
                               np.asarray(mcse_mean(h)), rtol=1e-5)


def test_compute_diagnostics_chunked_matches_monolithic():
    """The full gate-grade dict agrees with compute_diagnostics on every
    key (so runner gates could consume either)."""
    from mcmc_tpu.diagnostics import (compute_diagnostics,
                                      compute_diagnostics_chunked)
    h = _history(random.PRNGKey(5), S=48, C=12, D=4)
    a = compute_diagnostics(h)
    b = compute_diagnostics_chunked(h, chain_chunk=5, dim_chunk=3)
    for k in ("rhat_max", "rhat_mean", "ess_bulk_min", "ess_bulk_mean",
              "ess_tail_min", "ess_tail_mean"):
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    for k in ("mean", "sd", "mcse_mean", "ess_bulk", "ess_tail", "r_hat"):
        np.testing.assert_allclose(np.asarray(b["summary"][k]),
                                   np.asarray(a["summary"][k]),
                                   rtol=1e-5, err_msg=k)


def test_chunked_moments_accurate_for_uncentered_data():
    """float32 single-pass chain-mean variance cancels catastrophically for
    |mean| >> sd (review r2 finding: ess_mean_chunked returned the degenerate
    n*M at offset 1e4); centering on a first-chain location estimate fixes
    it. Check raw-draw ESS and MCSE at large offsets against monolithic."""
    from mcmc_tpu.diagnostics import (ess_mean, ess_mean_chunked, mcse_mean,
                                      mcse_mean_chunked)
    base = _history(random.PRNGKey(6), S=64, C=24, D=2).astype(jnp.float32)
    for offset in (1e4, 1e5):
        h = base + offset
        full = np.asarray(ess_mean(h.astype(jnp.float64))
                          if jnp.asarray(0.0).dtype == jnp.float64
                          else ess_mean(h))
        chunked = np.asarray(ess_mean_chunked(h, 8, 1))
        np.testing.assert_allclose(chunked, full, rtol=5e-2,
                                   err_msg=f"offset={offset}")
        np.testing.assert_allclose(np.asarray(mcse_mean_chunked(h, 8, 1)),
                                   np.asarray(mcse_mean(h)), rtol=5e-2,
                                   err_msg=f"offset={offset}")


def test_chunked_diagnostics_on_mesh_sharded_history(monkeypatch):
    """A chain-sharded history routes through the per-dim-sharded path
    (VERDICT r2 #4): each dim block is resharded so every device owns whole
    columns — no z[:, a:b] host slice ever touches the sharded chain axis,
    per-device peak memory is bounded by dims_per_device columns, and every
    statistic equals the unsharded monolithic one EXACTLY (same per-column
    code path)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    import mcmc_tpu.diagnostics.streaming as st
    from mcmc_tpu.parallel import make_mesh
    from mcmc_tpu.diagnostics import (
        compute_diagnostics, compute_diagnostics_chunked,
        ess_bulk_chunked, split_rhat_chunked, ess_tail_chunked)

    calls = []
    orig = st._per_dim_sharded

    def spy(samples, mesh, axis, column_fn, dims_per_device, **kw):
        calls.append(dims_per_device)
        return orig(samples, mesh, axis, column_fn, dims_per_device, **kw)

    monkeypatch.setattr(st, "_per_dim_sharded", spy)

    mesh = make_mesh(8)
    h = _history(random.PRNGKey(7), S=120, C=32, D=5)
    hs = jax.device_put(h, NamedSharding(mesh, P(None, "chains", None)))

    a = compute_diagnostics(h)
    b = compute_diagnostics_chunked(hs, dim_chunk=2)
    assert calls and all(d == 1 for d in calls), \
        "mesh history must dispatch per-dim-sharded with bounded block width"
    for k in ("rhat_max", "rhat_mean", "ess_bulk_min", "ess_bulk_mean",
              "ess_tail_min", "ess_tail_mean"):
        np.testing.assert_allclose(b[k], a[k], rtol=1e-10, err_msg=k)
    for k in ("mean", "sd", "mcse_mean", "ess_bulk", "ess_tail", "r_hat"):
        np.testing.assert_allclose(np.asarray(b["summary"][k]),
                                   np.asarray(a["summary"][k]),
                                   rtol=1e-10, err_msg=k)

    # individual estimators agree bitwise-close with their monolithic twins
    from mcmc_tpu.diagnostics import ess_bulk, split_rhat, ess_tail
    np.testing.assert_allclose(np.asarray(ess_bulk_chunked(hs)),
                               np.asarray(ess_bulk(h)), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(split_rhat_chunked(hs)),
                               np.asarray(split_rhat(h)), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(ess_tail_chunked(hs)),
                               np.asarray(ess_tail(h)), rtol=1e-12)
