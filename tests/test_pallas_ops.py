"""Fused trajectory kernel tests (Pallas interpreter on CPU).

Strategy (SURVEY.md §4 implication (b)): compare the fused kernel against the
XLA scan path — padded target math exactly, full trajectories with injected
randomness to float32 tolerance, and the production kernel statistically.
The GPU compiler cannot run here, but the Triton lowering can: every kernel
variant is lowered for CUDA, which catches any primitive the route refuses.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import jax.random as random

from mcmc_tpu.targets import get_target
from mcmc_tpu.ops import fused_trajectory as ft
from mcmc_tpu.ops.padded_targets import (KERNEL_FAMILIES, make_padded_vag,
                                         resolve_backend)
from mcmc_tpu.ops.fused_trajectory import (block_dim, chain_tile_for,
                                           make_debug_trajectory,
                                           make_fused_grahmc_step)
from mcmc_tpu.samplers import grahmc_init, get_friction_schedule
from mcmc_tpu.samplers.trajectory import integrate_trajectory, kinetic_energy

PALLAS_DIM = 20
GAUSSIAN_FAMILIES = sorted(set(KERNEL_FAMILIES)
                           - {"multimodal_funnel_2d", "concentric_l1_balls",
                              "nested_l1_balls"})


def _pad(x, width):
    return jnp.pad(x, ((0, 0), (0, width - x.shape[1])))


def _dense_metric(dim, seed=5):
    a = random.normal(random.PRNGKey(seed), (dim, dim), jnp.float32)
    return (a @ a.T / dim + jnp.eye(dim)).astype(jnp.float32)


@pytest.mark.parametrize("dim,expect", [(1, 16), (2, 16), (16, 16),
                                        (17, 32), (50, 64), (64, 64),
                                        (100, 128)])
def test_block_dim_is_power_of_two_at_least_16(dim, expect):
    assert block_dim(dim) == expect


def test_chain_tile_rules():
    assert chain_tile_for(65536) == ft.CHAIN_TILE
    assert chain_tile_for(3) == 16          # pl.dot row minimum
    assert chain_tile_for(20) == min(32, ft.CHAIN_TILE)
    tile = chain_tile_for(4096)
    assert tile >= 16 and tile & (tile - 1) == 0


@pytest.mark.parametrize("dim", [PALLAS_DIM, 7])
@pytest.mark.parametrize("name", GAUSSIAN_FAMILIES)
def test_padded_vag_matches_unpadded(name, dim):
    """Padded-block math == analytic math on real coords, zeros on padding,
    for a dim that fills most of its block and an odd one (7 of 16)."""
    t = get_target(name, dim=dim)
    key = random.PRNGKey(0)
    x = (t.init_sampler(key, 16) if t.init_sampler is not None
         else random.normal(key, (16, dim)))
    x32 = jnp.asarray(x, jnp.float32)
    d_pad = block_dim(dim)

    lp_pad, grad_pad = make_padded_vag(t.value_and_grad_fn, d_pad)(
        _pad(x32, d_pad))
    lp_ref, grad_ref = t.value_and_grad_fn(x32)
    np.testing.assert_allclose(np.asarray(lp_pad[:, 0]),
                               np.asarray(lp_ref, np.float32),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(grad_pad[:, :dim]),
                               np.asarray(grad_ref, np.float32),
                               rtol=2e-5, atol=2e-5)
    # padding coords must carry zero gradient (dynamics invariant)
    assert np.all(np.asarray(grad_pad[:, dim:]) == 0.0)


def test_padded_vag_requires_metadata():
    with pytest.raises(TypeError):
        make_padded_vag(lambda x: (x.sum(-1), x), 32)


def _xla_transition(t_vag, q, lp, grad, p0, u, eps, L, inv_mass, sched,
                    gamma, steep):
    """The XLA integrator + MH accept on the same injected randomness, at
    full float32 matmul precision (the reference the kernel must match)."""
    with jax.default_matmul_precision("highest"):
        qx, px, lpx, _ = integrate_trajectory(
            q, p0, lp, grad, t_vag, eps, L, inv_mass,
            friction_schedule=sched, gamma_max=gamma, steepness=steep)
        h0 = -lp + kinetic_energy(p0, inv_mass)
        h1 = -lpx + kinetic_energy(-px, inv_mass)
    accept = jnp.log(u) < jnp.minimum(0.0, h0 - h1)
    return jnp.where(accept[:, None], qx, q), accept, h1 - h0


@pytest.mark.parametrize("metric", ["diag", "dense"])
@pytest.mark.parametrize("schedule", [None, "tanh", "constant", "sine"])
def test_debug_kernel_matches_xla_trajectory(schedule, metric):
    """Injected-randomness fused transition == XLA conformal leapfrog + MH,
    for both metric kinds (the dense one through pl.dot)."""
    t = get_target("standard_normal", dim=PALLAS_DIM)
    n_chains, L = 8, 10
    eps, gamma, steep = 0.15, 0.8, 2.0
    k1, k2, k3 = random.split(random.PRNGKey(1), 3)
    q = random.normal(k1, (n_chains, PALLAS_DIM), dtype=jnp.float32)
    p0 = random.normal(k2, (n_chains, PALLAS_DIM), dtype=jnp.float32)
    u = random.uniform(k3, (n_chains,), dtype=jnp.float32)
    inv_mass = (jnp.linspace(0.5, 1.5, PALLAS_DIM, dtype=jnp.float32)
                if metric == "diag" else _dense_metric(PALLAS_DIM))
    lp, grad = t.value_and_grad_fn(q)
    lp, grad = lp.astype(jnp.float32), grad.astype(jnp.float32)
    sched_fn = get_friction_schedule(schedule) if schedule else None

    q_ref, accept_ref, dh_ref = _xla_transition(
        t.value_and_grad_fn, q, lp, grad, p0, u, eps, L, inv_mass, sched_fn,
        gamma, steep)
    run = make_debug_trajectory(t.value_and_grad_fn, L, sched_fn,
                                backend="interpret")
    q_k, lp_k, grad_k, accept_k, dh_k = run(q, lp, grad, p0, u, eps, gamma,
                                            steep, inv_mass)

    np.testing.assert_array_equal(np.asarray(accept_k), np.asarray(accept_ref))
    np.testing.assert_allclose(np.asarray(q_k), np.asarray(q_ref),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(dh_k), np.asarray(dh_ref),
                               rtol=2e-3, atol=2e-3)


def test_debug_kernel_funnel_matches_xla():
    """Same check on the funnel (exercises the coordinate-0 / mask handling)
    with a chain count that spans several blocks and leaves the last one
    partly empty."""
    t = get_target("neals_funnel", dim=PALLAS_DIM)
    n_chains, L = 2 * ft.CHAIN_TILE + 5, 6
    k1, k2, k3 = random.split(random.PRNGKey(2), 3)
    q = t.init_sampler(k1, n_chains).astype(jnp.float32)
    p0 = random.normal(k2, (n_chains, PALLAS_DIM), dtype=jnp.float32)
    u = random.uniform(k3, (n_chains,), dtype=jnp.float32)
    inv_mass = jnp.ones(PALLAS_DIM, jnp.float32)
    lp, grad = t.value_and_grad_fn(q)
    lp, grad = lp.astype(jnp.float32), grad.astype(jnp.float32)
    sched = get_friction_schedule("tanh")

    q_ref, accept_ref, dh_ref = _xla_transition(
        t.value_and_grad_fn, q, lp, grad, p0, u, 0.05, L, inv_mass, sched,
        1.0, 0.5)
    run = make_debug_trajectory(t.value_and_grad_fn, L, sched,
                                backend="interpret")
    q_k, _, _, accept_k, dh_k = run(q, lp, grad, p0, u, 0.05, 1.0, 0.5,
                                    inv_mass)
    np.testing.assert_array_equal(np.asarray(accept_k), np.asarray(accept_ref))
    np.testing.assert_allclose(np.asarray(q_k), np.asarray(q_ref),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(dh_k), np.asarray(dh_ref),
                               rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("metric", ["diag", "dense"])
@pytest.mark.parametrize("beta", [0.15, 0.7])
def test_bridge_kernel_matches_xla_mixture(beta, metric):
    """The `bridged` kernel variant (SMC move fusion) == XLA leapfrog on the
    hand-built geometric-bridge mixture beta*logp + (1-beta)*log N(m, s^2 I),
    with identical injected randomness, for both metric kinds."""
    from mcmc_tpu.samplers.smc import gaussian_base
    t = get_target("neals_funnel", dim=PALLAS_DIM)
    n_chains, L = 8, 6
    eps = 0.08
    base_mean, base_scale = 0.5, 2.0
    k1, k2, k3 = random.split(random.PRNGKey(5), 3)
    q = t.init_sampler(k1, n_chains).astype(jnp.float32)
    p0 = random.normal(k2, (n_chains, PALLAS_DIM), dtype=jnp.float32)
    u = random.uniform(k3, (n_chains,), dtype=jnp.float32)
    inv_mass = (jnp.ones(PALLAS_DIM, jnp.float32) if metric == "diag"
                else _dense_metric(PALLAS_DIM, seed=9))

    _, _, base_vag = gaussian_base(PALLAS_DIM, base_mean, base_scale)

    def mixture_vag(x):
        lt, gt = t.value_and_grad_fn(x)
        lb, gb = base_vag(x)
        return (beta * lt.astype(jnp.float32) + (1 - beta) * lb,
                beta * gt.astype(jnp.float32) + (1 - beta) * gb)

    lp, grad = mixture_vag(q)
    q_ref, accept_ref, dh_ref = _xla_transition(
        mixture_vag, q, lp, grad, p0, u, eps, L, inv_mass, None, 0.0, 1.0)
    run = make_debug_trajectory(t.value_and_grad_fn, L, None, backend="interpret")
    q_k, lp_k, _, accept_k, dh_k = run(
        q, lp, grad, p0, u, eps, 0.0, 1.0, inv_mass,
        bridge=(beta, base_mean, base_scale))

    np.testing.assert_array_equal(np.asarray(accept_k),
                                  np.asarray(accept_ref))
    np.testing.assert_allclose(np.asarray(q_k), np.asarray(q_ref),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(dh_k), np.asarray(dh_ref),
                               rtol=2e-3, atol=2e-3)


def test_scaled_kernel_matches_xla_tempered():
    """The `scaled` variant (tempering's lp_scale) == the XLA leapfrog on
    beta * log p."""
    t = get_target("gaussian_mixture", dim=10)
    n_chains, L, beta = 16, 6, 0.3
    k1, k2, k3 = random.split(random.PRNGKey(12), 3)
    q = random.normal(k1, (n_chains, 10), jnp.float32) * 2.0
    p0 = random.normal(k2, (n_chains, 10), jnp.float32)
    u = random.uniform(k3, (n_chains,), jnp.float32)
    inv_mass = jnp.ones(10, jnp.float32)

    def tempered_vag(x):
        lp, g = t.value_and_grad_fn(x)
        return (beta * lp.astype(jnp.float32), beta * g.astype(jnp.float32))

    lp, grad = tempered_vag(q)
    q_ref, accept_ref, _ = _xla_transition(
        tempered_vag, q, lp, grad, p0, u, 0.2, L, inv_mass, None, 0.0, 1.0)
    run = make_debug_trajectory(t.value_and_grad_fn, L, None, backend="interpret")
    q_k, _, _, accept_k, _ = run(q, lp, grad, p0, u, 0.2, 0.0, 1.0,
                                 inv_mass, lp_scale=beta)
    np.testing.assert_array_equal(np.asarray(accept_k), np.asarray(accept_ref))
    np.testing.assert_allclose(np.asarray(q_k), np.asarray(q_ref),
                               rtol=2e-4, atol=2e-4)


def test_bridge_beta_one_equals_plain_kernel():
    """beta=1 collapses the bridge mixture to the bare target exactly in
    IEEE arithmetic — the bridged kernel must reproduce the plain kernel's
    trajectory to the bit."""
    t = get_target("standard_normal", dim=PALLAS_DIM)
    n_chains, L = 8, 5
    k1, k2, k3 = random.split(random.PRNGKey(6), 3)
    q = random.normal(k1, (n_chains, PALLAS_DIM), dtype=jnp.float32)
    p0 = random.normal(k2, (n_chains, PALLAS_DIM), dtype=jnp.float32)
    u = random.uniform(k3, (n_chains,), dtype=jnp.float32)
    inv_mass = jnp.ones(PALLAS_DIM, jnp.float32)
    lp, grad = t.value_and_grad_fn(q)
    lp = lp.astype(jnp.float32)

    run = make_debug_trajectory(t.value_and_grad_fn, L, None, backend="interpret")
    plain = run(q, lp, grad, p0, u, 0.2, 0.0, 1.0, inv_mass)
    bridged = run(q, lp, grad, p0, u, 0.2, 0.0, 1.0, inv_mass,
                  bridge=(1.0, 0.0, 1.0))
    for a, b in zip(plain, bridged):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fused_step_statistical_correctness():
    """Production step (jax.random momenta, interpret mode): correct
    posterior moments and reasonable acceptance on N(0, I)."""
    t = get_target("standard_normal", dim=PALLAS_DIM)
    n_chains = 16
    state = grahmc_init(
        random.normal(random.PRNGKey(3), (n_chains, PALLAS_DIM)) * 0.5,
        t.log_prob_fn, t.value_and_grad_fn)
    fused = make_fused_grahmc_step(
        t.log_prob_fn, t.value_and_grad_fn, num_steps=8,
        friction_schedule=get_friction_schedule("constant"), backend="interpret")
    inv_mass = jnp.ones(PALLAS_DIM)
    step = jax.jit(lambda k, s: fused(k, s, 0.22, 0.3, 1.0, inv_mass))

    key = random.PRNGKey(4)
    draws = []
    for i in range(400):
        key, state, _ = step(key, state)
        if i >= 100:
            draws.append(np.asarray(state.position))
    draws = np.stack(draws)
    accept_rate = float(state.accept_count.sum()) / (400 * n_chains)
    assert 0.3 < accept_rate < 1.0
    flat = draws.reshape(-1, PALLAS_DIM)
    assert np.all(np.abs(flat.mean(0)) < 0.25)
    assert np.all(np.abs(flat.var(0) - 1.0) < 0.35)


def test_fused_step_counts_divergences():
    """Absurd step size must trip the divergence counter, not crash."""
    t = get_target("ill_conditioned_gaussian", dim=PALLAS_DIM)
    n_chains = 8
    state = grahmc_init(random.normal(random.PRNGKey(5), (n_chains, PALLAS_DIM)),
                        t.log_prob_fn, t.value_and_grad_fn)
    fused = make_fused_grahmc_step(
        t.log_prob_fn, t.value_and_grad_fn, num_steps=10,
        friction_schedule=get_friction_schedule("constant"), backend="interpret")
    key = random.PRNGKey(6)
    for _ in range(5):
        key, state, _ = fused(key, state, 8.0, 1.0, 1.0, jnp.ones(PALLAS_DIM))
    assert int(state.divergence_count.sum()) > 0
    assert np.all(np.isfinite(np.asarray(state.position)))


def test_grahmc_run_interpret_backend():
    """backend='interpret' (the kernel under the interpreter) through the
    public run API."""
    from mcmc_tpu.samplers import grahmc_run
    t = get_target("standard_normal", dim=PALLAS_DIM)
    res = grahmc_run(
        random.PRNGKey(7), t.log_prob_fn,
        random.normal(random.PRNGKey(8), (16, PALLAS_DIM)) * 0.5,
        step_size=0.2, num_steps=8, gamma=0.3, steepness=1.0,
        num_samples=150, burn_in=50,
        friction_schedule=get_friction_schedule("constant"),
        value_and_grad_fn=t.value_and_grad_fn, backend="interpret")
    assert res.samples.shape == (150, 16, PALLAS_DIM)
    assert 0.2 < float(res.accept_rate.mean()) <= 1.0
    flat = np.asarray(res.samples).reshape(-1, PALLAS_DIM)
    assert np.all(np.abs(flat.mean(0)) < 0.4)


def test_pallas_track_proposals_exports_true_endpoints():
    """Kernel track_proposals: proposals differ from post-MH samples
    exactly on rejected steps (true trajectory endpoints, XLA parity)."""
    from mcmc_tpu.samplers import grahmc_run
    t = get_target("standard_normal", dim=PALLAS_DIM)
    res = grahmc_run(
        random.PRNGKey(9), t.log_prob_fn,
        random.normal(random.PRNGKey(10), (16, PALLAS_DIM)),
        step_size=0.6, num_steps=8, gamma=0.5, steepness=1.0,
        num_samples=80, burn_in=0, track_proposals=True,
        friction_schedule=get_friction_schedule("constant"),
        value_and_grad_fn=t.value_and_grad_fn, backend="interpret")
    prop = np.asarray(res.info["proposal_positions"])
    post = np.asarray(res.samples)
    pre = np.asarray(res.info["pre_positions"])
    moved = ~np.all(np.isclose(post, pre, atol=1e-7), axis=-1)   # accepted
    # accepted steps: post == proposal; rejected: post == pre != proposal
    np.testing.assert_allclose(post[moved], prop[moved], rtol=1e-5)
    rejected = ~moved
    if rejected.any():
        assert not np.allclose(prop[rejected], post[rejected])


@pytest.mark.parametrize("d_pad_extra", [0, 1])
@pytest.mark.parametrize("name,dim", [("multimodal_funnel_2d", 2),
                                      ("concentric_l1_3d", 3),
                                      ("nested_l1_3d", 3)])
def test_padded_vag_rahmc_paper_targets(name, dim, d_pad_extra):
    """Padded specializations for the RAHMC-paper families: block math ==
    analytic math, zero grads on padding, at the kernel's block width and
    at twice it (the math must not depend on the padding width)."""
    t = get_target(name, dim=dim)
    x = t.init_sampler(random.PRNGKey(0), 16).astype(jnp.float32)
    d_pad = block_dim(dim) << d_pad_extra
    lp_pad, grad_pad = make_padded_vag(t.value_and_grad_fn, d_pad)(
        _pad(x, d_pad))
    lp_ref, grad_ref = t.value_and_grad_fn(x)
    np.testing.assert_allclose(np.asarray(lp_pad[:, 0]),
                               np.asarray(lp_ref, np.float32),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(grad_pad[:, :dim]),
                               np.asarray(grad_ref, np.float32),
                               rtol=2e-5, atol=2e-5)
    assert np.all(np.asarray(grad_pad[:, dim:]) == 0.0)


def test_grahmc_interpret_backend_rahmc_target():
    """The fused kernel runs end-to-end on a RAHMC-paper target (no silent
    XLA fallback)."""
    from mcmc_tpu.samplers import grahmc_run
    t = get_target("concentric_l1_2d", dim=2)
    res = grahmc_run(
        random.PRNGKey(2), t.log_prob_fn,
        t.init_sampler(random.PRNGKey(3), 16).astype(jnp.float32),
        step_size=0.1, num_steps=8, gamma=0.5, steepness=1.0,
        num_samples=60, burn_in=20,
        friction_schedule=get_friction_schedule("constant"),
        value_and_grad_fn=t.value_and_grad_fn, backend="interpret")
    assert res.samples.shape == (60, 16, 2)
    assert np.all(np.isfinite(np.asarray(res.samples)))


def _target_for_family(family):
    if family == "multimodal_funnel_2d":
        return get_target("multimodal_funnel_2d", dim=2)
    if family == "concentric_l1_balls":
        return get_target("concentric_l1_3d", dim=3)
    if family == "nested_l1_balls":
        return get_target("nested_l1_3d", dim=3)
    return get_target(family, dim=50)


def _lower_for_gpu(t, dense=False, bridge=None, lp_scale=None):
    """Lower one kernel variant for CUDA (Triton IR is emitted here; only
    the PTX compile needs the card) and return the lowered module text."""
    n_chains = 256
    dim = t.dim
    calls = ft._CallCache(ft._vag_cache(t.value_and_grad_fn), 16,
                          get_friction_schedule("tanh"), False)
    metric = (jnp.eye(dim, dtype=jnp.float32) if dense
              else jnp.ones(dim, jnp.float32))
    q = jnp.zeros((n_chains, dim), jnp.float32)
    lp = jnp.zeros((n_chains,), jnp.float32)

    def f(q, lp):
        return ft._transition(calls, q, lp, q, q, lp + 0.5, 0.1, 0.5, 1.0,
                              metric, lp_scale=lp_scale, bridge=bridge)

    return jax.jit(f).trace(q, lp).lower(
        lowering_platforms=("cuda",)).as_text()


@pytest.mark.parametrize("family", KERNEL_FAMILIES)
def test_kernel_lowers_through_triton_for_every_family(family):
    """Every family the resolver sends to the kernel lowers through the
    Triton route (no slicing or other primitive it refuses)."""
    text = _lower_for_gpu(_target_for_family(family))
    assert "fused_grahmc_transition" in text


@pytest.mark.parametrize("variant", ["dense", "bridge", "scaled"])
def test_kernel_variants_lower_through_triton(variant):
    t = get_target("neals_funnel", dim=50)
    kw = {"dense": dict(dense=True),
          "bridge": dict(bridge=(0.5, 0.0, 2.0)),
          "scaled": dict(lp_scale=0.3)}[variant]
    assert "fused_grahmc_transition" in _lower_for_gpu(t, **kw)


@pytest.mark.parametrize("name", ["rosenbrock", "hierarchical_logistic"])
def test_resolver_sends_unlowerable_families_to_xla(name):
    """Families without kernel math resolve to 'xla' even on a GPU, and an
    explicit kernel request for them fails loudly."""
    from mcmc_tpu.targets.hierarchical import hierarchical_logistic
    t = (hierarchical_logistic(dim=10, n_data=32)
         if name == "hierarchical_logistic" else get_target(name, dim=10))
    assert resolve_backend("auto", t.value_and_grad_fn, platform="gpu") \
        == "xla"
    with pytest.raises(KeyError):
        make_padded_vag(t.value_and_grad_fn, 16)


@pytest.mark.parametrize("platform,expect", [("gpu", "pallas"),
                                             ("cpu", "xla"),
                                             ("rocm", "xla")])
def test_resolver_per_platform(platform, expect):
    """'auto' picks the kernel only on a GPU; explicit choices pass
    through on every platform; unknown names fail."""
    t = get_target("neals_funnel", dim=10)
    vag = t.value_and_grad_fn
    assert resolve_backend("auto", vag, platform=platform) == expect
    for explicit in ("xla", "pallas", "interpret"):
        assert resolve_backend(explicit, vag, platform=platform) == explicit
    assert resolve_backend("auto", lambda x: x, platform=platform) == "xla"
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("triton", vag, platform=platform)


def test_compiled_kernel_refused_off_gpu():
    """Asking for the compiled kernel where there is no GPU raises instead
    of falling back to the interpreter."""
    t = get_target("standard_normal", dim=4)
    with pytest.raises(RuntimeError, match="interpret"):
        make_fused_grahmc_step(t.log_prob_fn, t.value_and_grad_fn,
                               num_steps=4, friction_schedule=None)
    with pytest.raises(RuntimeError, match="interpret"):
        make_debug_trajectory(t.value_and_grad_fn, 4, None)


def test_kernel_path_handles_odd_chain_counts():
    """Chain counts that leave the last block partly empty (2 x prime) must
    sample every chain (masked rows, not a skipped tile)."""
    from mcmc_tpu.samplers import grahmc_run
    from mcmc_tpu.samplers.grahmc import constant_schedule
    from mcmc_tpu.targets import standard_normal

    t = standard_normal(6)
    C = 274                       # 2 x 137
    init = jnp.full((C, 6), 5.0, jnp.float32)   # far from the mode: any
    # chain left frozen by a skipped block stays at exactly 5.0
    res = grahmc_run(
        random.PRNGKey(0), t.log_prob_fn, init, step_size=0.3, num_steps=4,
        gamma=0.5, steepness=1.0, num_samples=64, burn_in=0,
        friction_schedule=constant_schedule,
        value_and_grad_fn=t.value_and_grad_fn, backend="interpret")
    moved = np.any(np.asarray(res.final_state.position) != 5.0, axis=1)
    assert moved.all(), f"{(~moved).sum()} chains never updated"


def test_kernel_factory_memoized_per_target_lifetime():
    """Factories memoize per live target and free kernels when it dies.

    Guards the memoize_on_target contract (ops/memo.py): repeat calls on the
    same target instance return the identical compiled-kernel closure (no
    re-trace per window), distinct instances never share (their closures
    differ), and dropping the target releases the cache — a module-level
    lru_cache would pin dead targets' executables until 32 newer entries
    evicted them.
    """
    import gc
    import weakref

    t1 = get_target("standard_normal", dim=4)
    f1 = make_fused_grahmc_step(t1.log_prob_fn, t1.value_and_grad_fn,
                                num_steps=4, friction_schedule=None,
                                backend="interpret")
    f2 = make_fused_grahmc_step(t1.log_prob_fn, t1.value_and_grad_fn,
                                num_steps=4, friction_schedule=None,
                                backend="interpret")
    assert f1 is f2

    t2 = get_target("standard_normal", dim=4)
    f3 = make_fused_grahmc_step(t2.log_prob_fn, t2.value_and_grad_fn,
                                num_steps=4, friction_schedule=None,
                                backend="interpret")
    assert f3 is not f1

    ref = weakref.ref(f1)
    del f1, f2, t1
    gc.collect()
    assert ref() is None, "kernel cache outlived its target"


# ---- compiled kernel on the card (skip elsewhere) --------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["diag", "dense"])
def test_compiled_kernel_matches_interpreter(gpu, metric):
    """The Triton-compiled kernel and the same kernel under the interpreter
    agree on the same inputs (float32 reassociation only)."""
    t = get_target("neals_funnel", dim=50)
    n_chains, L = 4096, 16
    k1, k2, k3 = random.split(random.PRNGKey(21), 3)
    q = (random.normal(k1, (n_chains, 50)) * 0.5).astype(jnp.float32)
    p0 = random.normal(k2, (n_chains, 50), jnp.float32)
    u = random.uniform(k3, (n_chains,), jnp.float32)
    lp, grad = t.value_and_grad_fn(q)
    lp, grad = lp.astype(jnp.float32), grad.astype(jnp.float32)
    inv_mass = (jnp.ones(50, jnp.float32) if metric == "diag"
                else _dense_metric(50))
    sched = get_friction_schedule("tanh")
    args = (q, lp, grad, p0, u, 0.05, 0.3, 0.5, inv_mass)
    compiled = make_debug_trajectory(t.value_and_grad_fn, L, sched)(*args)
    interp = make_debug_trajectory(t.value_and_grad_fn, L, sched,
                                   backend="interpret")(*args)
    assert np.mean(np.asarray(compiled[3]) == np.asarray(interp[3])) > 0.999
    np.testing.assert_allclose(np.asarray(compiled[0]), np.asarray(interp[0]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_auto_backend_runs_compiled_kernel(gpu):
    """On the GPU backend='auto' resolves to the compiled kernel, which
    samples N(0, I) with the right moments through grahmc_run."""
    from mcmc_tpu.samplers import grahmc_run
    t = get_target("standard_normal", dim=PALLAS_DIM)
    assert resolve_backend("auto", t.value_and_grad_fn) == "pallas"
    res = grahmc_run(
        random.PRNGKey(7), t.log_prob_fn,
        random.normal(random.PRNGKey(8), (1024, PALLAS_DIM), jnp.float32),
        step_size=0.2, num_steps=8, gamma=0.1, steepness=1.0,
        num_samples=200, burn_in=50,
        friction_schedule=get_friction_schedule("constant"),
        value_and_grad_fn=t.value_and_grad_fn)
    flat = np.asarray(res.samples, np.float64).reshape(-1, PALLAS_DIM)
    assert 0.5 < float(res.accept_rate.mean()) <= 1.0
    assert np.all(np.abs(flat.mean(0)) < 0.05)
    assert np.all(np.abs(flat.var(0) - 1.0) < 0.05)
