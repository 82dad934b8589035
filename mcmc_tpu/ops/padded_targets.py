"""Padding-aware analytic value-and-grad for the fused trajectory kernel.

The kernel works on (chain_tile, d_pad) blocks: chains on rows, the dim axis
padded to a power of two (Triton's block rule). Padded entries of q are ZERO
(the kernel's masked loads fill them so, and momenta and gradients are
zeroed there), so each target family only needs:

- reductions that ignore zero entries (sums of per-coordinate terms vanish),
- dimension CONSTANTS taken from the true dim, not the padded extent,
- explicit masking where zero inputs still produce nonzero gradients
  (correlated Gaussian's b*sum(x) term, log-gamma's positivity test).

Every builder is written from operations the Triton route lowers: elementwise
math, iota, select and row reductions. A kernel cannot capture constant
arrays and the route has no slicing, so masks and eigenvalue rows are rebuilt
from iota and single coordinates are read by masked row sums. Builders are
keyed by the ``pallas_info`` metadata the target factories attach to their
value_and_grad closures.

Families whose math does not lower this way (Rosenbrock's neighbour
couplings need a shifted copy of the block; the hierarchical logistic needs
its design matrix as a kernel operand) have no builder: the backend resolver
sends them to the XLA integrator.
"""

import math
from typing import Callable

import numpy as np
from scipy.special import gammaln

import jax
import jax.numpy as jnp
from jax import lax

LOG_2PI = math.log(2.0 * math.pi)


def _ids(d_pad):
    """Coordinate-index row (1, d_pad), broadcastable against a block."""
    return lax.broadcasted_iota(jnp.int32, (1, d_pad), 1)


def _mask_row(dim, d_pad, dtype=jnp.float32):
    """Mask row: 1 for real coordinates, 0 for padding."""
    return (_ids(d_pad) < dim).astype(dtype)


def _coord(q, i, d_pad):
    """i-th coordinate of every chain, keepdims: (C, 1)."""
    return jnp.sum(jnp.where(_ids(d_pad) == i, q, 0.0), axis=1,
                   keepdims=True)


def make_padded_vag(value_and_grad_fn: Callable, d_pad: int) -> Callable:
    """Build block -> (lp, grad) for a tagged target: q (C, d_pad) ->
    lp (C, 1), grad (C, d_pad).

    Raises TypeError when the closure carries no pallas_info and KeyError for
    families without a kernel specialization (see KERNEL_FAMILIES).
    """
    info = getattr(value_and_grad_fn, "pallas_info", None)
    if info is None:
        raise TypeError(
            "value_and_grad_fn has no pallas_info metadata; the Pallas "
            "backend needs a target built by mcmc_tpu.targets")
    return _BUILDERS[info["family"]](info["dim"], d_pad, info["params"])


def _standard_normal(dim, d_pad, params):
    const = dim * LOG_2PI

    def vag(q):
        lp = -0.5 * (jnp.sum(q * q, axis=1, keepdims=True) + const)
        return lp, -q
    return vag


def _ill_conditioned(dim, d_pad, params):
    kappa = params["condition_number"]
    # linspace(1, kappa, dim)[i] = 1 + (kappa - 1) * i / (dim - 1)
    slope = (kappa - 1.0) / max(dim - 1, 1)
    const = float(np.sum(np.log(np.linspace(1.0, kappa, dim)))) + dim * LOG_2PI

    def vag(q):
        ids = _ids(d_pad)
        eig = 1.0 + slope * ids.astype(jnp.float32)
        inv_eig = jnp.where(ids < dim, 1.0 / eig, 0.0)
        siv = q * inv_eig
        lp = -0.5 * (jnp.sum(siv * q, axis=1, keepdims=True) + const)
        return lp, -siv
    return vag


def _correlated(dim, d_pad, params):
    a = params["a"]
    b = params["b"]
    const = params["log_det_cov"] + dim * LOG_2PI

    def vag(q):
        mask = _mask_row(dim, d_pad)
        s = jnp.sum(q, axis=1, keepdims=True)       # zeros in padding: exact
        siv = (a * q + b * s) * mask                # mask: b*s leaks into padding
        lp = -0.5 * (jnp.sum(siv * q, axis=1, keepdims=True) + const)
        return lp, -siv
    return vag


def _neals_funnel(dim, d_pad, params):
    d_rest = dim - 1
    log_2pi9 = math.log(2.0 * math.pi * 9.0)

    def vag(q):
        mask = _mask_row(dim, d_pad)
        coord0 = _ids(d_pad) == 0
        x0 = _coord(q, 0, d_pad)
        inv_var = jnp.exp(-x0)
        rest = jnp.where(coord0, 0.0, q)             # zero the neck coordinate
        sum_sq = jnp.sum(rest * rest, axis=1, keepdims=True)
        lp = (-0.5 * (x0 * x0 / 9.0 + log_2pi9)
              - 0.5 * (sum_sq * inv_var + d_rest * x0 + d_rest * LOG_2PI))
        g0 = -x0 / 9.0 + 0.5 * inv_var * sum_sq - 0.5 * d_rest
        grad = jnp.where(coord0, g0, -q * inv_var) * mask
        return lp, grad
    return vag


def _neals_funnel_noncentered(dim, d_pad, params):
    """Non-centered funnel: diagonal Gaussian, var 9 on the neck coordinate
    and 1 elsewhere (the funnel curvature lives in the post-hoc transform,
    not the sampled density — targets/__init__.py neals_funnel_noncentered)."""
    const = math.log(9.0) + dim * LOG_2PI

    def vag(q):
        mask = _mask_row(dim, d_pad)
        coord0 = _ids(d_pad) == 0
        inv_var = jnp.where(coord0, 1.0 / 9.0, 1.0) * mask
        siv = q * inv_var
        lp = -0.5 * (jnp.sum(siv * q, axis=1, keepdims=True) + const)
        return lp, -siv
    return vag


def _student_t(dim, d_pad, params):
    df = params["df"]
    log_norm = float(gammaln((df + 1.0) / 2.0) - gammaln(df / 2.0)) \
        - 0.5 * math.log(df * math.pi)
    const = dim * log_norm

    def vag(q):
        lp = const - ((df + 1.0) / 2.0) * jnp.sum(
            jnp.log1p(q * q / df), axis=1, keepdims=True)
        grad = -(df + 1.0) * q / (df + q * q)
        return lp, grad
    return vag


def _log_gamma(dim, d_pad, params):
    shape, rate = params["shape"], params["rate"]
    eps = 1e-10
    log_norm = float(gammaln(shape)) + shape * math.log(rate)

    def vag(q):
        mask = _mask_row(dim, d_pad)
        pos = q > 0
        invalid = jnp.where(pos | (mask == 0), 0.0, 1.0)
        valid = jnp.sum(invalid, axis=1, keepdims=True) == 0
        qc = jnp.maximum(q, eps)
        terms = ((shape - 1.0) * jnp.log(qc) - rate * q - log_norm) * mask
        lp = jnp.where(valid, jnp.sum(terms, axis=1, keepdims=True), -math.inf)
        g = ((shape - 1.0) * jnp.where(q > eps, 1.0 / qc, 0.0) - rate) * mask
        grad = jnp.where(valid, g, 0.0)
        return lp, grad
    return vag


def _log_gamma_unconstrained(dim, d_pad, params):
    """expGamma: the log-transformed reparameterization of log_gamma
    (targets/__init__.py unconstrain_target). lp = sum(shape*y - rate*e^y)
    - dim*logZ, grad = shape - rate*e^y — smooth on all of R^D, so the
    divergence gate that fails the constrained family at its support
    boundary never fires. Padded entries sit at y=0 where the per-coordinate
    term and gradient are nonzero (-rate, shape-rate), hence the mask."""
    shape, rate = params["shape"], params["rate"]
    const = dim * (float(gammaln(shape)) + shape * math.log(rate))

    def vag(q):
        mask = _mask_row(dim, d_pad)
        ey = jnp.exp(q)
        lp = jnp.sum((shape * q - rate * ey) * mask,
                     axis=1, keepdims=True) - const
        grad = (shape - rate * ey) * mask
        return lp, grad
    return vag


def _gaussian_mixture(dim, d_pad, params):
    half_sep = params["separation"] / 2.0
    d_rest = dim - 1

    def vag(q):
        mask = _mask_row(dim, d_pad)
        coord0 = _ids(d_pad) == 0
        x0 = _coord(q, 0, d_pad)
        m1 = -0.5 * (x0 + half_sep) ** 2
        m2 = -0.5 * (x0 - half_sep) ** 2
        mx = jnp.maximum(m1, m2)
        e1 = jnp.exp(m1 - mx)
        e2 = jnp.exp(m2 - mx)
        lse = e1 + e2
        log_p_x0 = math.log(0.5) + mx + jnp.log(lse) - 0.5 * LOG_2PI
        rest = jnp.where(coord0, 0.0, q)
        lp = log_p_x0 - 0.5 * (jnp.sum(rest * rest, axis=1, keepdims=True)
                               + d_rest * LOG_2PI)
        g0 = -((x0 + half_sep) * e1 + (x0 - half_sep) * e2) / lse
        grad = jnp.where(coord0, g0, -q) * mask
        return lp, grad
    return vag


def _multimodal_funnel_2d(dim, d_pad, params):
    mu, sigma, c = params["mu"], params["sigma"], params["c"]
    sig2 = sigma * sigma
    log_norm_prior = math.log(0.5) - 0.5 * math.log(2.0 * math.pi * sig2)
    log_2pi_c = math.log(2.0 * math.pi * c)

    def vag(q):
        coord0 = _ids(d_pad) == 0
        coord1 = _ids(d_pad) == 1
        v = _coord(q, 0, d_pad)
        x = _coord(q, 1, d_pad)
        a1 = -0.5 * (v - mu) ** 2 / sig2
        a2 = -0.5 * (v + mu) ** 2 / sig2
        mx = jnp.maximum(a1, a2)
        e1 = jnp.exp(a1 - mx)
        e2 = jnp.exp(a2 - mx)
        lse = e1 + e2
        log_prior = log_norm_prior + mx + jnp.log(lse)
        inv_var = jnp.exp(-v) / c
        log_cond = -0.5 * (x * x * inv_var + v + log_2pi_c)
        lp = log_prior + log_cond
        w1 = e1 / lse
        w2 = e2 / lse
        gv = (-(w1 * (v - mu) + w2 * (v + mu)) / sig2
              + 0.5 * x * x * inv_var - 0.5)
        gx = -x * inv_var
        grad = jnp.where(coord0, gv, jnp.where(coord1, gx, 0.0))
        return lp, grad
    return vag


def _logsumexp_terms(terms):
    """Unrolled logsumexp over a list of (C, 1) terms: (max, exps, lse)."""
    mx = terms[0]
    for t in terms[1:]:
        mx = jnp.maximum(mx, t)
    exps = [jnp.exp(t - mx) for t in terms]
    lse = exps[0]
    for e in exps[1:]:
        lse = lse + e
    return mx, exps, lse


def _concentric_l1(dim, d_pad, params):
    radii = params["radii"]
    sig2 = params["sigma"] ** 2

    def vag(q):
        mask = _mask_row(dim, d_pad)
        u = jnp.sum(jnp.abs(q) * mask, axis=1, keepdims=True)
        mx, exps, lse = _logsumexp_terms(
            [-0.5 * (u - r) ** 2 / sig2 for r in radii])
        du = exps[0] * (-(u - radii[0]) / sig2)
        for e, r in zip(exps[1:], radii[1:]):
            du = du + e * (-(u - r) / sig2)
        grad = du / lse * jnp.sign(q) * mask
        return mx + jnp.log(lse), grad
    return vag


def _nested_l1(dim, d_pad, params):
    r_outer, r_inner = params["r_outer"], params["r_inner"]
    mu_norm, n_inner = params["mu_norm"], params["n_inner"]
    sig2 = params["sigma"] ** 2
    # centres: origin (radius r_outer) + axis points (radius r_inner);
    # axis/sign are scalars, so each centre's offset is rebuilt from iota
    centres = [(None, 0.0, r_outer)]
    for j in range(n_inner):
        centres.append(((j // 2) % dim, 1.0 if j % 2 == 0 else -1.0, r_inner))

    def vag(q):
        mask = _mask_row(dim, d_pad)
        ids = _ids(d_pad)
        diffs, us = [], []
        for axis, sign, _r in centres:
            if axis is None:
                d = q
            else:
                d = q - jnp.where(ids == axis, sign * mu_norm, 0.0)
            d = d * mask
            diffs.append(d)
            us.append(jnp.sum(jnp.abs(d), axis=1, keepdims=True))
        mx, exps, lse = _logsumexp_terms(
            [-0.5 * (u - c[2]) ** 2 / sig2 for u, c in zip(us, centres)])
        grad = jnp.zeros_like(q)
        for e, u, c, d in zip(exps, us, centres, diffs):
            grad = grad + (e * (-(u - c[2]) / sig2)) * jnp.sign(d)
        grad = grad / lse * mask
        return mx + jnp.log(lse), grad
    return vag


_BUILDERS = {
    "standard_normal": _standard_normal,
    "ill_conditioned_gaussian": _ill_conditioned,
    "correlated_gaussian": _correlated,
    "neals_funnel": _neals_funnel,
    "neals_funnel_noncentered": _neals_funnel_noncentered,
    "student_t": _student_t,
    "log_gamma": _log_gamma,
    "log_gamma_unconstrained": _log_gamma_unconstrained,
    "gaussian_mixture": _gaussian_mixture,
    "multimodal_funnel_2d": _multimodal_funnel_2d,
    "concentric_l1_balls": _concentric_l1,
    "nested_l1_balls": _nested_l1,
}

KERNEL_FAMILIES = tuple(_BUILDERS)
BACKENDS = ("auto", "xla", "pallas", "interpret")


def kernel_family(value_and_grad_fn):
    """The target's family when the fused kernel has its math, else None."""
    info = getattr(value_and_grad_fn, "pallas_info", None)
    if info is None or info["family"] not in KERNEL_FAMILIES:
        return None
    return info["family"]


def resolve_backend(backend: str, value_and_grad_fn,
                    platform: str = None) -> str:
    """The one backend predicate. Explicit choices pass through: 'xla' (the
    scan integrator), 'pallas' (the compiled kernel, GPU only) and
    'interpret' (the same kernel under the Pallas interpreter, any
    platform). 'auto' is 'pallas' only on a GPU (the kernel is compiled
    through Triton) and only for a target whose family has kernel math
    (KERNEL_FAMILIES); everything else runs the XLA integrator.
    ``platform`` defaults to jax.default_backend()."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend != "auto":
        return backend
    platform = platform or jax.default_backend()
    if platform == "gpu" and kernel_family(value_and_grad_fn) is not None:
        return "pallas"
    return "xla"
