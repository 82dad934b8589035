"""Target distributions for MCMC benchmarking.

Feature parity with the reference's ``benchmarks/targets.py`` (see reference
targets.py:23-701): the same 8 analytic targets + the 3 RAHMC-paper targets that the
reference imports from its (missing) ``benchmarks/rahmc_paper_targets.py``
(reference targets.py:506-524 documents their factory signatures).

Differences from the reference:

- Every target carries a **batched analytic value-and-grad** (``value_and_grad_fn``)
  derived by hand and checked against ``jax.grad`` to float64 tolerance in
  ``tests/test_targets.py``. This removes per-chain ``vmap(jax.value_and_grad(...))``
  from the hot loop and — critically — lets the fused Pallas kernels compute target
  gradients inside the kernel, where ``jax.grad`` cannot be used.
- ``family``/``params`` metadata lets downstream layers (Pallas kernels, reference
  samplers) specialize per target without string-parsing names.
- Reference samplers are batched on-device RNG (one fused kernel per draw batch).
"""

from typing import Callable, NamedTuple, Optional, Dict, Any

import jax
import jax.numpy as jnp
import jax.random as random
from jax.scipy.special import gammaln


class TargetDistribution(NamedTuple):
    """Container for a target distribution specification.

    Field layout is a superset of the reference's TargetDistribution
    (reference targets.py:23-31) so user code written against the reference works
    unchanged; the extra fields power the fused kernel path.
    """
    log_prob_fn: Callable[[jnp.ndarray], jnp.ndarray]
    dim: int
    true_mean: Optional[jnp.ndarray]
    true_cov: Optional[jnp.ndarray]
    name: str
    description: str
    init_sampler: Optional[Callable] = None      # (key, n_chains) -> (n_chains, dim)
    value_and_grad_fn: Optional[Callable] = None  # x:(..., dim) -> (lp:(...,), grad:(..., dim))
    family: str = ""
    params: Dict[str, Any] = {}
    # Optional deterministic map from the SAMPLED coordinates to the
    # coordinates of interest (non-centered parameterizations); None for
    # targets sampled directly in their natural coordinates. When set,
    # `transform_target` names the registered target whose ground-truth
    # sampler lives in the TRANSFORMED coordinates — the benchmark runner
    # then also reports `sliced_w2_transformed` against it.
    transform: Optional[Callable] = None
    transform_target: Optional[str] = None
    # Support of the density over the SAMPLED coordinates: 'real' (R^D) or
    # 'positive' (x > 0 coordinate-wise). Gradient samplers on constrained
    # supports diverge at every boundary crossing (the reference's log_gamma
    # clamp+(-inf) guard, reference targets.py:216-270, makes |dH| > 1000
    # there); `unconstrain_target` uses this tag to build the standard
    # log-transformed reparameterization.
    support: str = "real"
    # Analytic moments of `transform(samples)` — set by reparameterized
    # targets so the benchmark runner can ALSO z-test the constrained
    # coordinates against the original target's ground truth (gating
    # quality_pass for reparam rows).
    transform_true_mean: Optional[jnp.ndarray] = None
    transform_true_cov: Optional[jnp.ndarray] = None


def _batched(x):
    """Return (x2d, squeeze) so 1-D inputs work like the reference's targets."""
    x = jnp.asarray(x)
    if x.ndim == 1:
        return x[None, :], True
    return x, False


def _tag(fn, family, dim, **params):
    """Attach kernel metadata to an analytic value-and-grad closure so the
    Pallas layer (mcmc_tpu.ops) can build a padding-aware specialization."""
    fn.pallas_info = {"family": family, "dim": dim, "params": params}
    return fn


# ============================================================================
# Target factories (analytic log-probs with hand-derived gradients)
# ============================================================================

def standard_normal(dim: int = 10) -> TargetDistribution:
    """N(0, I). log p = -0.5*(sum x^2 + D log 2pi); grad = -x.

    Parity: reference targets.py:38-61.
    """
    def log_prob_fn(x):
        D = x.shape[-1]
        return -0.5 * (jnp.sum(x**2, axis=-1) + D * jnp.log(2.0 * jnp.pi))

    def value_and_grad_fn(x):
        D = x.shape[-1]
        lp = -0.5 * (jnp.sum(x**2, axis=-1) + D * jnp.log(2.0 * jnp.pi))
        return lp, -x

    _tag(value_and_grad_fn, "standard_normal", dim)
    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=jnp.zeros(dim),
        true_cov=jnp.eye(dim),
        name=f"StandardNormal{dim}D",
        description=f"{dim}D standard normal N(0, I) - tests basic correctness",
        value_and_grad_fn=value_and_grad_fn,
        family="standard_normal",
        params={},
    )


def correlated_gaussian(dim: int = 10, correlation: float = 0.9) -> TargetDistribution:
    """Compound-symmetry Gaussian: Sigma = (1-rho) I + rho J.

    Closed forms (parity: reference targets.py:64-107):
      Sigma^{-1} = a I + b J with a = 1/(1-rho), b = -rho/((1-rho)(1+(D-1)rho))
      log|Sigma| = (D-1) log(1-rho) + log(1+(D-1)rho)
    grad log p = -(Sigma^{-1} x) = -(a x + b * sum(x) * 1) — O(D), no matmul.
    """
    rho = correlation
    cov = (1.0 - rho) * jnp.eye(dim) + rho * jnp.ones((dim, dim))
    a = 1.0 / (1.0 - rho)
    b = -rho / ((1.0 - rho) * (1.0 + (dim - 1) * rho))
    log_det_cov = (dim - 1) * jnp.log(1.0 - rho) + jnp.log(1.0 + (dim - 1) * rho)

    def value_and_grad_fn(x):
        D = x.shape[-1]
        s = jnp.sum(x, axis=-1, keepdims=True)          # (..., 1)
        sigma_inv_x = a * x + b * s                      # (..., D)
        mahal = jnp.sum(sigma_inv_x * x, axis=-1)
        lp = -0.5 * (mahal + log_det_cov + D * jnp.log(2.0 * jnp.pi))
        return lp, -sigma_inv_x

    def log_prob_fn(x):
        return value_and_grad_fn(x)[0]

    _tag(value_and_grad_fn, "correlated_gaussian", dim, a=float(a), b=float(b), log_det_cov=float(log_det_cov))
    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=jnp.zeros(dim),
        true_cov=cov,
        name=f"CorrelatedGaussian{dim}D_rho{correlation}",
        description=f"{dim}D Gaussian with correlation rho={correlation} - tests handling of correlation",
        value_and_grad_fn=value_and_grad_fn,
        family="correlated_gaussian",
        params={"correlation": correlation},
    )


def ill_conditioned_gaussian(dim: int = 10, condition_number: float = 100.0) -> TargetDistribution:
    """Diagonal Gaussian with eigenvalues linspace(1, kappa, D).

    Parity: reference targets.py:110-146. grad = -x / lambda.
    """
    eigenvalues = jnp.linspace(1.0, condition_number, dim)
    inv_eig = 1.0 / eigenvalues
    log_det_cov = jnp.sum(jnp.log(eigenvalues))

    def value_and_grad_fn(x):
        D = x.shape[-1]
        sigma_inv_x = x * inv_eig
        mahal = jnp.sum(sigma_inv_x * x, axis=-1)
        lp = -0.5 * (mahal + log_det_cov + D * jnp.log(2.0 * jnp.pi))
        return lp, -sigma_inv_x

    def log_prob_fn(x):
        return value_and_grad_fn(x)[0]

    _tag(value_and_grad_fn, "ill_conditioned_gaussian", dim, condition_number=condition_number)
    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=jnp.zeros(dim),
        true_cov=jnp.diag(eigenvalues),
        name=f"IllConditioned{dim}D_kappa{int(condition_number)}",
        description=f"{dim}D Gaussian with kappa={condition_number} - tests ill-conditioning",
        value_and_grad_fn=value_and_grad_fn,
        family="ill_conditioned_gaussian",
        params={"condition_number": condition_number},
    )


def neals_funnel(dim: int = 10) -> TargetDistribution:
    """Neal's funnel: x0 ~ N(0,9); x_i | x0 ~ N(0, exp(x0)).

    Parity: reference targets.py:149-213 (incl. Var[x_i] = exp(4.5)).
    Gradients (hand-derived):
      d/dx0  = -x0/9 + 0.5 * exp(-x0) * sum(x_rest^2) - D_rest/2
      d/dxi  = -x_i * exp(-x0)
    """
    D_rest = dim - 1

    def value_and_grad_fn(x):
        x0 = x[..., 0]
        x_rest = x[..., 1:]
        sum_sq = jnp.sum(x_rest**2, axis=-1)
        inv_var = jnp.exp(-x0)
        lp = (-0.5 * (x0**2 / 9.0 + jnp.log(2.0 * jnp.pi * 9.0))
              - 0.5 * (sum_sq * inv_var + D_rest * x0 + D_rest * jnp.log(2.0 * jnp.pi)))
        g0 = -x0 / 9.0 + 0.5 * inv_var * sum_sq - 0.5 * D_rest
        g_rest = -x_rest * inv_var[..., None]
        grad = jnp.concatenate([g0[..., None], g_rest], axis=-1)
        return lp, grad

    def log_prob_fn(x):
        return value_and_grad_fn(x)[0]

    def init_sampler(key, n_chains):
        # Sample neck from its prior; keep the rest at unit scale (exp(0)=1) to
        # avoid extreme initial gradients (matches reference targets.py:187-193).
        key1, key2 = random.split(key)
        x0 = random.normal(key1, (n_chains, 1)) * 3.0
        x_rest = random.normal(key2, (n_chains, dim - 1))
        return jnp.concatenate([x0, x_rest], axis=1)

    var_rest = jnp.exp(4.5)
    true_cov_diag = jnp.concatenate([jnp.array([9.0]), jnp.ones(dim - 1) * var_rest])

    _tag(value_and_grad_fn, "neals_funnel", dim)
    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=jnp.zeros(dim),
        true_cov=jnp.diag(true_cov_diag),
        name=f"NealsFunnel{dim}D",
        description=f"{dim}D Neal's funnel - tests varying curvature and scale",
        init_sampler=init_sampler,
        value_and_grad_fn=value_and_grad_fn,
        family="neals_funnel",
        params={},
    )


def funnel_transform(y: jnp.ndarray) -> jnp.ndarray:
    """Map non-centered funnel draws y = (v, z) to centered funnel
    coordinates x = (v, z * exp(v/2)); batched over leading axes."""
    v = y[..., :1]
    return jnp.concatenate([v, y[..., 1:] * jnp.exp(v / 2.0)], axis=-1)


def neals_funnel_noncentered(dim: int = 10) -> TargetDistribution:
    """Neal's funnel, non-centered parameterization (the standard remedy).

    The centered funnel (reference targets.py:149-213) defeats every sampler
    at gate grade — the three-way parity experiment (BASELINE.md "Funnel
    apples-to-apples") shows the reference and this rebuild failing
    identically on the neck's varying curvature. The textbook fix is to
    SAMPLE auxiliary coordinates y = (v, z) with v ~ N(0, 9) and
    z_i ~ N(0, 1) i.i.d. — a well-conditioned diagonal Gaussian — and
    recover funnel draws deterministically via `funnel_transform`
    (x0 = v, x_i = z_i * exp(v/2)), which reproduces the funnel's exact
    moments (Var[x0] = 9, Var[x_i] = e^{4.5}).

    Diagnostics and gates are evaluated in the sampled coordinates (Stan
    practice: diagnose the parameterization you sample); the benchmark
    runner additionally reports `sliced_w2_transformed` — W2 of the
    transformed draws against the CENTERED funnel's exact sampler (via
    `transform`/`transform_target`).
    Gradients: d/dv = -v/9; d/dz_i = -z_i.
    """
    D_rest = dim - 1

    def value_and_grad_fn(y):
        v = y[..., 0]
        z = y[..., 1:]
        lp = (-0.5 * (v**2 / 9.0 + jnp.log(2.0 * jnp.pi * 9.0))
              - 0.5 * (jnp.sum(z**2, axis=-1) + D_rest * jnp.log(2.0 * jnp.pi)))
        grad = jnp.concatenate([(-v / 9.0)[..., None], -z], axis=-1)
        return lp, grad

    def log_prob_fn(y):
        return value_and_grad_fn(y)[0]

    true_cov_diag = jnp.concatenate([jnp.array([9.0]), jnp.ones(dim - 1)])

    _tag(value_and_grad_fn, "neals_funnel_noncentered", dim)
    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=jnp.zeros(dim),
        true_cov=jnp.diag(true_cov_diag),
        name=f"NealsFunnelNonCentered{dim}D",
        description=(f"{dim}D Neal's funnel, non-centered parameterization - "
                     f"same funnel moments via funnel_transform"),
        value_and_grad_fn=value_and_grad_fn,
        family="neals_funnel_noncentered",
        params={},
        transform=funnel_transform,
        transform_target="neals_funnel",
    )


def log_gamma(dim: int = 10, shape: float = 2.0, rate: float = 1.0) -> TargetDistribution:
    """Independent Gamma(shape, rate) per dimension, -inf outside x > 0.

    Parity: reference targets.py:216-270 (incl. the log(max(x, 1e-10)) clamp).
    grad_i = (shape-1) * 1{x_i > eps} / max(x_i, eps) - rate, zeroed when any
    coordinate is non-positive (matching jax.grad of the reference's jnp.where).
    """
    eps = 1e-10
    log_normalizer = gammaln(shape) + shape * jnp.log(rate)

    def value_and_grad_fn(x):
        valid = jnp.all(x > 0, axis=-1)
        xc = jnp.maximum(x, eps)
        log_pdf = (shape - 1.0) * jnp.log(xc) - rate * x - log_normalizer
        lp = jnp.where(valid, jnp.sum(log_pdf, axis=-1), -jnp.inf)
        g = (shape - 1.0) * jnp.where(x > eps, 1.0 / xc, 0.0) - rate
        grad = jnp.where(valid[..., None], g, 0.0)
        return lp, grad

    def log_prob_fn(x):
        return value_and_grad_fn(x)[0]

    def init_sampler(key, n_chains):
        return random.gamma(key, shape, (n_chains, dim)) / rate

    true_var = shape / (rate ** 2)

    _tag(value_and_grad_fn, "log_gamma", dim, shape=shape, rate=rate)
    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=jnp.ones(dim) * (shape / rate),
        true_cov=jnp.eye(dim) * true_var,
        name=f"LogGamma{dim}D_shape{shape}_rate{rate}",
        description=f"{dim}D independent Gamma - tests heavy tails and asymmetry",
        init_sampler=init_sampler,
        value_and_grad_fn=value_and_grad_fn,
        family="log_gamma",
        params={"shape": shape, "rate": rate},
        support="positive",
    )


# ============================================================================
# Unconstraining reparameterization (Stan's transform layer, on device)
# ============================================================================

def exp_transform(y):
    """Map unconstrained draws y back to the positive orthant, x = e^y."""
    return jnp.exp(y)


def unconstrain_target(target: TargetDistribution,
                       registry_name: Optional[str] = None) -> TargetDistribution:
    """Return the log-transformed reparameterization of a constrained target.

    The standard remedy (Stan reference manual ch. 10) for gradient samplers
    on constrained supports: sample y = log x over all of R^D with
    log p_y(y) = log p_x(e^y) + sum(y) (the log-Jacobian), and map draws
    back via `transform` = exp. The reference has no counterpart — its
    log_gamma rows only survive because its divergence rate is hard-coded
    0.0 (reference run_benchmarks.py:706-710); with real |dH|>1000 detection
    every support-boundary crossing diverges (12/16 canonical-matrix cells).
    The transformed density is smooth on R^D, so divergences vanish.

    Targets with support='real' are returned unchanged. For log_gamma the
    unconstrained density is analytic (expGamma): lp = sum(shape*y - rate*e^y)
    - D*log Z with moments E[y] = psi(shape) - log(rate), Var[y] =
    psi'(shape), and it carries a fused-kernel (Pallas) specialization
    (ops/padded_targets.py family 'log_gamma_unconstrained'). Other
    positive-support targets get a generic chain-rule wrapper
    (grad_y = grad_x(e^y) * e^y + 1) that runs on the XLA path.

    Diagnostics/gates run in the SAMPLED coordinates (Stan practice); the
    benchmark runner additionally z-tests and W2-tests the transformed
    draws against the ORIGINAL target's ground truth via
    `transform_true_mean`/`transform_true_cov`/`transform_target`.

    registry_name: the registry key of `target` (e.g. 'log_gamma') so the
    transformed-coordinate W2 can look up the original exact sampler.
    """
    if target.support == "real":
        return target
    if target.support != "positive":
        raise ValueError(f"No unconstraining transform for support="
                         f"{target.support!r} (target {target.name})")

    dim = target.dim

    if target.family == "log_gamma":
        from scipy.special import digamma as _sp_digamma, polygamma as _sp_polygamma
        shape, rate = target.params["shape"], target.params["rate"]
        # expGamma(shape, rate): lp(y) = sum(shape*y - rate*e^y) - D*logZ,
        # reusing the reference's normalizer convention
        # (gammaln(shape) + shape*log(rate), reference targets.py:232).
        log_normalizer = gammaln(shape) + shape * jnp.log(rate)

        def value_and_grad_fn(y):
            ey = jnp.exp(y)
            lp = jnp.sum(shape * y - rate * ey, axis=-1) - dim * log_normalizer
            return lp, shape - rate * ey

        _tag(value_and_grad_fn, "log_gamma_unconstrained", dim,
             shape=shape, rate=rate)
        true_mean = jnp.full(dim, float(_sp_digamma(shape)) - jnp.log(rate))
        true_cov = jnp.eye(dim) * float(_sp_polygamma(1, shape))
        family = "log_gamma_unconstrained"
    else:
        base_vag = target.value_and_grad_fn

        def value_and_grad_fn(y):
            x = jnp.exp(y)
            lp_x, g_x = base_vag(x)
            return lp_x + jnp.sum(y, axis=-1), g_x * x + 1.0

        # no pallas_info tag: unknown-family reparams run on the XLA path
        true_mean = None
        true_cov = None
        family = f"{target.family}_unconstrained"

    def log_prob_fn(y):
        return value_and_grad_fn(y)[0]

    base_init = target.init_sampler
    if base_init is not None:
        def init_sampler(key, n_chains):
            return jnp.log(jnp.maximum(base_init(key, n_chains), 1e-12))
    else:
        init_sampler = None

    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=true_mean,
        true_cov=true_cov,
        name=f"{target.name}_log",
        description=(f"log-transformed (unconstrained) reparameterization "
                     f"of {target.name}; draws map back via exp"),
        init_sampler=init_sampler,
        value_and_grad_fn=value_and_grad_fn,
        family=family,
        params=dict(target.params),
        transform=exp_transform,
        transform_target=registry_name,
        support="real",
        transform_true_mean=target.true_mean,
        transform_true_cov=target.true_cov,
    )


def student_t(dim: int = 10, df: float = 3.0) -> TargetDistribution:
    """Independent Student-t(df) per dimension.

    Parity: reference targets.py:273-334. grad_i = -(df+1) x_i / (df + x_i^2).
    """
    log_normalizer = float(gammaln((df + 1.0) / 2.0) - gammaln(df / 2.0)) - 0.5 * jnp.log(df * jnp.pi)

    def value_and_grad_fn(x):
        D = x.shape[-1]
        lp = D * log_normalizer - ((df + 1.0) / 2.0) * jnp.sum(jnp.log1p(x**2 / df), axis=-1)
        grad = -(df + 1.0) * x / (df + x**2)
        return lp, grad

    def log_prob_fn(x):
        return value_and_grad_fn(x)[0]

    def init_sampler(key, n_chains):
        # Overdispersed init (std=2) to cover the heavy tails
        # (matches reference targets.py:313-316).
        return random.normal(key, (n_chains, dim)) * 2.0

    true_cov = jnp.eye(dim) * (df / (df - 2.0)) if df > 2 else None

    _tag(value_and_grad_fn, "student_t", dim, df=df)
    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=jnp.zeros(dim),
        true_cov=true_cov,
        name=f"StudentT{dim}D_df{df}",
        description=f"{dim}D independent Student-t(df={df}) - tests heavy tails and non-Gaussian geometry",
        init_sampler=init_sampler,
        value_and_grad_fn=value_and_grad_fn,
        family="student_t",
        params={"df": df},
    )


def rosenbrock(dim: int = 10, scale: float = 0.1) -> TargetDistribution:
    """Rosenbrock density: log p = -sum[(1-x_i)^2 + a (x_{i+1}-x_i^2)^2], a = 1/scale^2.

    Parity: reference targets.py:337-408. Hand-derived gradient of -U:
      dU/dx_i = [-2(1-x_i) - 4 a x_i (x_{i+1}-x_i^2)]  for i < D-1  (forward coupling)
              + [ 2 a (x_i - x_{i-1}^2)]               for i > 0    (backward coupling)
    """
    a = 1.0 / (scale ** 2)

    def value_and_grad_fn(x):
        x_cur = x[..., :-1]
        x_next = x[..., 1:]
        resid = x_next - x_cur**2                      # (..., D-1)
        U = jnp.sum((1.0 - x_cur)**2 + a * resid**2, axis=-1)
        # dU/dx via the two coupling terms, assembled with zero-padded shifts.
        zeros = jnp.zeros_like(x[..., :1])
        dU_fwd = jnp.concatenate([-2.0 * (1.0 - x_cur) - 4.0 * a * x_cur * resid, zeros], axis=-1)
        dU_bwd = jnp.concatenate([zeros, 2.0 * a * resid], axis=-1)
        return -U, -(dU_fwd + dU_bwd)

    def log_prob_fn(x):
        return value_and_grad_fn(x)[0]

    def init_sampler(key, n_chains):
        # Near the mode (1,...,1) with noise, as the reference does
        # (targets.py:389-393).
        return jnp.ones((n_chains, dim)) + random.normal(key, (n_chains, dim)) * 0.5

    _tag(value_and_grad_fn, "rosenbrock", dim, scale=scale)
    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=jnp.ones(dim),  # mode as proxy; moments not tractable
        true_cov=None,
        name=f"Rosenbrock{dim}D_scale{scale}",
        description=f"{dim}D Rosenbrock(scale={scale}) - tests curved valleys and non-linear geometry",
        init_sampler=init_sampler,
        value_and_grad_fn=value_and_grad_fn,
        family="rosenbrock",
        params={"scale": scale},
    )


def gaussian_mixture(dim: int = 10, n_modes: int = 2, separation: float = 5.0) -> TargetDistribution:
    """x0 ~ 0.5 N(-sep/2, 1) + 0.5 N(+sep/2, 1); x_i ~ N(0,1) for i > 0.

    Parity: reference targets.py:411-482 (incl. Var[x0] = 1 + (sep/2)^2).
    d log p / d x0 = -(x0 + s/2) w1 - (x0 - s/2) w2 with softmax weights w.
    """
    if n_modes != 2:
        raise NotImplementedError("Only 2-mode mixture currently supported")
    half_sep = separation / 2.0

    def value_and_grad_fn(x):
        x0 = x[..., 0]
        x_rest = x[..., 1:]
        D_rest = x.shape[-1] - 1
        m1 = -0.5 * (x0 + half_sep) ** 2
        m2 = -0.5 * (x0 - half_sep) ** 2
        mx = jnp.maximum(m1, m2)
        e1 = jnp.exp(m1 - mx)
        e2 = jnp.exp(m2 - mx)
        lse = e1 + e2
        log_p_x0 = jnp.log(0.5) + mx + jnp.log(lse) - 0.5 * jnp.log(2.0 * jnp.pi)
        lp = log_p_x0 - 0.5 * (jnp.sum(x_rest**2, axis=-1) + D_rest * jnp.log(2.0 * jnp.pi))
        w1 = e1 / lse
        w2 = e2 / lse
        g0 = -(x0 + half_sep) * w1 - (x0 - half_sep) * w2
        grad = jnp.concatenate([g0[..., None], -x_rest], axis=-1)
        return lp, grad

    def log_prob_fn(x):
        return value_and_grad_fn(x)[0]

    def init_sampler(key, n_chains):
        # Half the chains near each mode (matches reference targets.py:456-465,
        # including reusing key1 for both halves).
        key1, key2 = random.split(key)
        n_half = n_chains // 2
        x0_m1 = random.normal(key1, (n_half,)) - half_sep
        x0_m2 = random.normal(key1, (n_chains - n_half,)) + half_sep
        x0 = jnp.concatenate([x0_m1, x0_m2])[:, None]
        x_rest = random.normal(key2, (n_chains, dim - 1))
        return jnp.concatenate([x0, x_rest], axis=1)

    var_x0 = 1.0 + half_sep ** 2
    true_cov_diag = jnp.concatenate([jnp.array([var_x0]), jnp.ones(dim - 1)])

    _tag(value_and_grad_fn, "gaussian_mixture", dim, separation=separation)
    return TargetDistribution(
        log_prob_fn=log_prob_fn,
        dim=dim,
        true_mean=jnp.zeros(dim),
        true_cov=jnp.diag(true_cov_diag),
        name=f"GaussianMixture{dim}D_modes{n_modes}_sep{separation}",
        description=f"{dim}D Gaussian mixture (x[0] bimodal) - tests mode-switching",
        init_sampler=init_sampler,
        value_and_grad_fn=value_and_grad_fn,
        family="gaussian_mixture",
        params={"n_modes": n_modes, "separation": separation},
    )


# ============================================================================
# Registry
# ============================================================================

def get_target(name: str, dim: int = 10, **kwargs) -> TargetDistribution:
    """Get a target distribution by name (parity: reference targets.py:489-530).

    Includes the RAHMC-paper targets the reference registers at targets.py:520-524
    (implemented in mcmc_tpu.targets.rahmc_paper since the reference module that
    defined them is missing from its snapshot).

    Any constrained-support target is additionally available under
    '<name>_unconstrained' — its log-transformed reparameterization built by
    `unconstrain_target` (beyond-reference; the runner's --reparam auto uses
    this path for every positive-support target).
    """
    if name.endswith('_unconstrained'):
        base = name[:-len('_unconstrained')]
        return unconstrain_target(get_target(base, dim=dim, **kwargs),
                                  registry_name=base)
    from mcmc_tpu.targets.rahmc_paper import (
        multimodal_funnel_2d, concentric_l1_balls, nested_l1_balls,
    )
    from mcmc_tpu.targets.hierarchical import hierarchical_logistic

    targets = {
        'standard_normal': standard_normal,
        'correlated_gaussian': correlated_gaussian,
        'ill_conditioned_gaussian': ill_conditioned_gaussian,
        'student_t': student_t,
        'log_gamma': log_gamma,
        'rosenbrock': rosenbrock,
        'neals_funnel': neals_funnel,
        'neals_funnel_noncentered': neals_funnel_noncentered,
        'gaussian_mixture': gaussian_mixture,
        # RAHMC paper targets (low-dimensional; fixed parameters per reference
        # targets.py:520-524)
        'multimodal_funnel_2d': lambda dim=2, **kw: multimodal_funnel_2d(mu=3.0, sigma=1.0, c=1.0),
        'concentric_l1_2d': lambda dim=2, **kw: concentric_l1_balls(dim=2, radii=(4.0, 8.0, 16.0), sigma=0.5),
        'concentric_l1_3d': lambda dim=3, **kw: concentric_l1_balls(dim=3, radii=(4.0, 8.0, 16.0), sigma=0.5),
        'nested_l1_2d': lambda dim=2, **kw: nested_l1_balls(dim=2, r_outer=20.0, r_inner=2.0, mu_norm=2.0, sigma=0.5, n_inner=4),
        'nested_l1_3d': lambda dim=3, **kw: nested_l1_balls(dim=3, r_outer=20.0, r_inner=2.0, mu_norm=2.0, sigma=0.5, n_inner=4),
        # BASELINE config 5: hierarchical Bayesian logistic posterior
        'hierarchical_logistic': hierarchical_logistic,
    }

    if name not in targets:
        raise ValueError(f"Unknown target '{name}'. Available: {list(targets.keys())}")

    return targets[name](dim=dim, **kwargs)


def list_targets():
    """Print available target distributions with descriptions."""
    for factory in (standard_normal, correlated_gaussian, ill_conditioned_gaussian,
                    student_t, log_gamma, rosenbrock, neals_funnel, gaussian_mixture):
        t = factory(10)
        print(f"\n{t.name}\n  {t.description}\n  dim={t.dim} "
              f"mean={'yes' if t.true_mean is not None else 'no'} "
              f"cov={'yes' if t.true_cov is not None else 'no'} "
              f"init={'yes' if t.init_sampler is not None else 'no'}")


# ============================================================================
# Exact reference samplers (ground truth for Sliced-W2)
# ============================================================================

def get_reference_sampler(target_name: str, dim: int = 10, **kwargs):
    """Exact i.i.d. sampler for a target, or None (parity: targets.py:561-687).

    Each returned function has signature (key, n) -> (n, dim) and runs as a single
    fused on-device kernel.

    '<name>_unconstrained' targets sample y = log x, so their exact sampler
    is the log of the base target's exact draws (exact by change of
    variables — e.g. log of Gamma draws is exactly expGamma-distributed).
    """
    if target_name.endswith('_unconstrained'):
        base = target_name[:-len('_unconstrained')]
        inner = get_reference_sampler(base, dim, **kwargs)
        if inner is None:
            return None
        return lambda key, n: jnp.log(jnp.maximum(inner(key, n), 1e-300))
    if target_name == 'standard_normal':
        return lambda key, n: random.normal(key, (n, dim))

    if target_name == 'correlated_gaussian':
        rho = kwargs.get('correlation', 0.9)
        cov = (1.0 - rho) * jnp.eye(dim) + rho * jnp.ones((dim, dim))
        L = jnp.linalg.cholesky(cov)
        return lambda key, n: random.normal(key, (n, dim)) @ L.T

    if target_name == 'ill_conditioned_gaussian':
        kappa = kwargs.get('condition_number', 100.0)
        scales = jnp.sqrt(jnp.linspace(1.0, kappa, dim))
        return lambda key, n: random.normal(key, (n, dim)) * scales

    if target_name == 'student_t':
        df = kwargs.get('df', 3.0)
        def sampler(key, n):
            k1, k2 = random.split(key)
            z = random.normal(k1, (n, dim))
            chi2 = random.gamma(k2, df / 2.0, (n, 1)) * 2.0
            return z / jnp.sqrt(chi2 / df)
        return sampler

    if target_name == 'log_gamma':
        shape = kwargs.get('shape', 2.0)
        rate = kwargs.get('rate', 1.0)
        return lambda key, n: random.gamma(key, shape, (n, dim)) / rate

    if target_name == 'neals_funnel':
        def sampler(key, n):
            k1, k2 = random.split(key)
            v = random.normal(k1, (n,)) * 3.0
            x_rest = random.normal(k2, (n, dim - 1)) * jnp.exp(v / 2.0)[:, None]
            return jnp.concatenate([v[:, None], x_rest], axis=1)
        return sampler

    if target_name == 'neals_funnel_noncentered':
        def sampler(key, n):
            k1, k2 = random.split(key)
            v = random.normal(k1, (n, 1)) * 3.0
            return jnp.concatenate([v, random.normal(k2, (n, dim - 1))],
                                   axis=1)
        return sampler

    if target_name == 'gaussian_mixture':
        n_modes = kwargs.get('n_modes', 2)
        separation = kwargs.get('separation', 5.0)
        if n_modes != 2:
            return None
        def sampler(key, n):
            k1, k2, k3 = random.split(key, 3)
            comp = random.bernoulli(k1, 0.5, (n,))
            x0 = random.normal(k2, (n,)) + jnp.where(comp, separation / 2.0, -separation / 2.0)
            x_rest = random.normal(k3, (n, dim - 1))
            return jnp.concatenate([x0[:, None], x_rest], axis=1)
        return sampler

    if target_name == 'multimodal_funnel_2d':
        from mcmc_tpu.targets.rahmc_paper import multimodal_funnel_2d_sampler
        return multimodal_funnel_2d_sampler(mu=kwargs.get('mu', 3.0),
                                            sigma=kwargs.get('sigma', 1.0),
                                            c=kwargs.get('c', 1.0))

    if target_name == 'rosenbrock':
        # The Rosenbrock density has no exact sampler; ground truth is a cached
        # long NUTS run (reference targets.py:646-684 loads pre-generated .npy).
        from mcmc_tpu.targets.rosenbrock_reference import load_rosenbrock_reference
        reference_samples = load_rosenbrock_reference(dim, scale=kwargs.get('scale', 0.1))
        if reference_samples is None:
            return None
        def sampler(key, n):
            n_avail = reference_samples.shape[0]
            n = min(n, n_avail)
            idx = random.choice(key, n_avail, shape=(n,), replace=False)
            return reference_samples[idx]
        return sampler

    return None


def has_reference_sampler(target_name: str) -> bool:
    """Parity: reference targets.py:690-701 (+ multimodal_funnel_2d, which has an
    exact sampler here)."""
    if target_name.endswith('_unconstrained'):
        return has_reference_sampler(target_name[:-len('_unconstrained')])
    return target_name in [
        'standard_normal',
        'correlated_gaussian',
        'ill_conditioned_gaussian',
        'student_t',
        'log_gamma',
        'neals_funnel',
        'neals_funnel_noncentered',
        'gaussian_mixture',
        'rosenbrock',
        'multimodal_funnel_2d',
    ]
