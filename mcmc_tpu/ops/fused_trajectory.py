"""Fused HMC/GRAHMC transition as one Pallas kernel, compiled through Triton.

One kernel call = one full MH transition for a tile of chains, with the
chain state held on the SM for the whole trajectory:

  L conformal-leapfrog substeps with the analytic target gradient inlined
  (friction gamma(t) evaluated per substep; absent for HMC)
  -> energies with the non-finite guard
  -> Metropolis accept and state select

The XLA integrator (samplers/trajectory.py) is a scan of L substeps, and an
elementwise target has no matmul to hide behind, so each substep writes the
(chains, d) q/p/grad state back to device memory. Here that state crosses
device memory once per transition.

Randomness is drawn outside with jax.random: the momenta p0 (one (C, d) read
per transition) and the accept uniforms. The kernel body is therefore
deterministic given its inputs, which is what the parity tests against the
XLA trajectory rely on.

Layout: blocks of (chain_tile, d_pad) with chains on rows and the dim axis
padded to a power of two (Triton's block rule; at least 16, the smallest
operand `pl.dot` takes for the dense metric). Arrays stay unpadded in device
memory; masked loads zero-fill the padding columns and the rows past the
last chain, and masked stores drop them. The kernel is float32 throughout;
the dense metric's matmul runs at full float32 precision (not TF32).
"""

import math
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax, random
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from mcmc_tpu import precision
from mcmc_tpu.ops.memo import memoize_on_target
from mcmc_tpu.ops.padded_targets import make_padded_vag

ENERGY_OVERFLOW = 1e10
DIVERGENCE_DELTA_H = 1000.0
TWO_PI = 2.0 * math.pi
N_SCALARS = 8             # scalar operand length (a power of two)
# Chains per block and warps per block, chosen by a tile sweep on the H100
# (PERF.md, "Kernel decisions on the H100").
CHAIN_TILE = 32
NUM_WARPS = 4


def block_dim(dim: int) -> int:
    """Padded block width of the dim axis: a power of two, at least 16."""
    return max(16, pl.next_power_of_2(dim))


def chain_tile_for(n_chains: int) -> int:
    """Power-of-two chain tile: CHAIN_TILE, no larger than needed for
    n_chains, and at least 16 (the row minimum of `pl.dot`)."""
    return max(16, min(CHAIN_TILE, pl.next_power_of_2(n_chains)))


class PreparedDenseMetric(NamedTuple):
    """A dense M^{-1} factored ONCE for reuse across fused-kernel calls.

    The fused closures accept this anywhere they accept a raw (dim, dim)
    inv_mass_matrix. Inside `lax.switch` branches (ChEES quantized-jitter
    sampling) XLA's loop-invariant code motion cannot hoist the Cholesky
    and triangular solve out of the nested branch computations, so a raw
    dense metric would pay them on EVERY draw; preparing up front moves the
    factorization outside the scan."""
    invm: jax.Array      # (d_pad, d_pad) zero-padded M^{-1}
    l_inv: jax.Array     # (dim, dim) lower-triangular L^{-1}, M^{-1} = L L^T


def prepare_dense_metric(inv_mass_matrix, dim: int) -> PreparedDenseMetric:
    """Factor a dense (dim, dim) M^{-1} once, outside any sampling loop.

    With M^{-1} = L L^T, momenta p = z L^{-1} (rows = chains) have
    covariance L^{-T} L^{-1} = M — the matmul form of sample_momentum's
    triangular solve (samplers/trajectory.py)."""
    from jax.scipy.linalg import solve_triangular

    invm = jnp.asarray(inv_mass_matrix, jnp.float32)
    chol = jnp.linalg.cholesky(invm)
    l_inv = solve_triangular(chol, jnp.eye(dim, dtype=jnp.float32),
                             lower=True)
    pad = block_dim(dim) - dim
    return PreparedDenseMetric(jnp.pad(invm, ((0, pad), (0, pad))), l_inv)


def is_dense_metric(inv_mass_matrix) -> bool:
    """True for a raw (D, D) matrix or a PreparedDenseMetric."""
    return (isinstance(inv_mass_matrix, PreparedDenseMetric)
            or jnp.ndim(inv_mass_matrix) == 2)


def _metric_ops(invm, dense: bool):
    """(velocity, kinetic) closures for a diagonal or dense metric.

    Diagonal: invm is a (1, d_pad) row of M^{-1} diag entries. Dense: invm
    is the zero-padded (d_pad, d_pad) M^{-1} and velocity is one float32
    matmul per call (M^{-1} is symmetric, so p @ M^{-1} is M^{-1} p per
    chain)."""
    if dense:
        def vel(p):
            return pl.dot(p, invm, precision=lax.Precision.HIGHEST)
    else:
        def vel(p):
            return p * invm

    def kin(p):
        return 0.5 * jnp.sum(p * vel(p), axis=1, keepdims=True)

    return vel, kin


def _integrate(q0, p0, lp0, grad0, vag, eps, num_steps, friction_schedule,
               gamma_max, steepness, vel):
    """L conformal-leapfrog substeps on the block (the hot loop). `vel`
    maps momentum to velocity M^{-1} p (see _metric_ops)."""
    half_eps = 0.5 * eps
    total_time = eps * num_steps

    def substep(i, carry):
        q, p, lp, grad = carry
        if friction_schedule is not None:
            # midpoint friction grid (samplers/trajectory.py) — keeps the
            # kernel consistent with the XLA integrator AND the conformal
            # map volume-neutral + involutive
            gamma_t = friction_schedule((i.astype(jnp.float32) + 0.5) * eps,
                                        total_time, gamma_max, steepness)
            scale = jnp.exp(-gamma_t * half_eps)
            p = p * scale
        p = p + half_eps * grad
        q = q + eps * vel(p)
        lp, grad = vag(q)
        p = p + half_eps * grad
        if friction_schedule is not None:
            p = p * scale
        return (q, p, lp, grad)

    return lax.fori_loop(0, num_steps, substep, (q0, p0, lp0, grad0))


def _make_kernel(padded_vag: Callable, num_steps: int,
                 friction_schedule: Optional[Callable], n_chains: int,
                 dim: int, tile: int, d_pad: int, dense: bool,
                 scaled: bool, bridged: bool):
    """Kernel body factory. Ref order:
    scalars, q, lp, grad, p0, u, inv_mass [, base_mean, base_inv_scale]
    -> q_out, lp_out, grad_out, acc_out, dh_out, prop_q_out, prop_lp_out.

    (C, dim) arrays are read as (tile, d_pad) blocks and per-chain arrays
    as (tile,) blocks; rows past n_chains and columns past dim are masked.
    scalars = [eps, gamma, steepness, lp_scale | beta, base_log_norm, 0...].
    """
    if scaled and bridged:
        raise ValueError("scaled and bridged kernels are mutually exclusive")

    def kernel(scal_ref, q_ref, lp_ref, grad_ref, p0_ref, u_ref, invm_ref,
               *rest):
        if bridged:
            bmean_ref, biscale_ref, *rest = rest
        (q_out, lp_out, grad_out, acc_out, dh_out,
         prop_out, prop_lp_out) = rest

        rows = pl.program_id(0) * tile + lax.broadcasted_iota(
            jnp.int32, (tile,), 0)
        row_ok = rows < n_chains
        col_ok = lax.broadcasted_iota(jnp.int32, (1, d_pad), 1) < dim
        block_ok = row_ok[:, None] & col_ok

        def load_block(ref):
            return plgpu.load(ref, mask=block_ok, other=0.0)

        def load_chains(ref):
            return plgpu.load(ref, mask=row_ok, other=0.0)[:, None]

        def store_block(ref, val):
            plgpu.store(ref, val, mask=block_ok)

        def store_chains(ref, val):
            plgpu.store(ref, val.reshape(tile), mask=row_ok)

        eps = scal_ref[0]
        gamma_max = scal_ref[1]
        steepness = scal_ref[2]
        vag = padded_vag
        if scaled:
            # Tempered-replica support (samplers/tempered.py): the target
            # log-density and gradient are scaled by a runtime beta inside
            # the hot loop. Static-gated so the untempered kernel pays
            # nothing for it.
            lp_scale = scal_ref[3]

            def vag(qq):
                lp_s, g_s = padded_vag(qq)
                return lp_scale * lp_s, lp_scale * g_s
        if bridged:
            # Annealed-SMC geometric bridge (samplers/smc.py): the move
            # kernel targets pi_b = beta*logp + (1-beta)*log N(mean, S^2 I)
            # with a RUNTIME beta; the spherical-Gaussian base is evaluated
            # in-kernel from broadcast mean / 1/scale rows, whose padding
            # entries load as ZERO, so padded coordinates contribute nothing.
            beta = scal_ref[3]
            base_log_norm = scal_ref[4]
            row_mask = jnp.broadcast_to(col_ok, (1, d_pad))
            bmean = plgpu.load(bmean_ref, mask=row_mask, other=0.0)
            biscale = plgpu.load(biscale_ref, mask=row_mask, other=0.0)

            def vag(qq):
                lt, gt = padded_vag(qq)
                z = (qq - bmean) * biscale
                lb = (-0.5 * jnp.sum(z * z, axis=1, keepdims=True)
                      + base_log_norm)
                return (beta * lt + (1.0 - beta) * lb,
                        beta * gt - (1.0 - beta) * (z * biscale))

        if dense:
            invm = invm_ref[...]
        else:
            invm = plgpu.load(invm_ref, mask=jnp.broadcast_to(
                col_ok, (1, d_pad)), other=0.0)
        vel, kin = _metric_ops(invm, dense)

        q0 = load_block(q_ref)
        lp0 = load_chains(lp_ref)
        p0 = load_block(p0_ref)
        h0 = -lp0 + kin(p0)

        q1, p1, lp1, grad1 = _integrate(
            q0, p0, lp0, load_block(grad_ref), vag, eps, num_steps,
            friction_schedule, gamma_max, steepness, vel)

        h1 = -lp1 + kin(-p1)              # momentum flip for reversibility
        finite = jnp.isfinite(h1)
        h1 = jnp.where(finite, h1, ENERGY_OVERFLOW)
        u = plgpu.load(u_ref, mask=row_ok, other=0.5)[:, None]
        # non-finite proposals are rejected outright (see grahmc_step)
        accept = finite & (jnp.log(u) < jnp.minimum(0.0, h0 - h1))

        # the start state is re-read rather than carried through the loop:
        # it would otherwise hold registers for the whole trajectory
        store_block(q_out, jnp.where(accept, q1, load_block(q_ref)))
        store_block(grad_out, jnp.where(accept, grad1, load_block(grad_ref)))
        store_chains(lp_out, jnp.where(accept, lp1, lp0))
        store_chains(acc_out, accept.astype(jnp.float32))
        store_chains(dh_out, h1 - h0)
        # true trajectory endpoint (the MH proposal), exported regardless of
        # the accept decision — exact track_proposals/ESJD parity with the
        # XLA step
        store_block(prop_out, q1)
        store_chains(prop_lp_out, lp1)

    return kernel


def _build_call(padded_vag, num_steps, friction_schedule, n_chains, dim,
                interpret, dense=False, scaled=False, bridged=False):
    d_pad = block_dim(dim)
    tile = chain_tile_for(n_chains)
    kernel = _make_kernel(padded_vag, num_steps, friction_schedule,
                          n_chains, dim, tile, d_pad, dense, scaled, bridged)
    block = pl.BlockSpec((tile, d_pad), lambda i: (i, 0))
    per_chain = pl.BlockSpec((tile,), lambda i: (i,))
    row = pl.BlockSpec((1, d_pad), lambda i: (0, 0))
    whole = pl.BlockSpec((N_SCALARS,), lambda i: (0,))
    invm_spec = (pl.BlockSpec((d_pad, d_pad), lambda i: (0, 0)) if dense
                 else row)
    in_specs = [whole, block, per_chain, block, block, per_chain, invm_spec]
    if bridged:
        in_specs += [row, row]

    def f32(shape):
        return jax.ShapeDtypeStruct(shape, jnp.float32)

    return pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n_chains, tile),),
        in_specs=in_specs,
        out_specs=[block, per_chain, block, per_chain, per_chain, block,
                   per_chain],
        out_shape=[f32((n_chains, dim)), f32((n_chains,)),
                   f32((n_chains, dim)), f32((n_chains,)), f32((n_chains,)),
                   f32((n_chains, dim)), f32((n_chains,))],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="fused_grahmc_transition",
    )


def _interpret(backend: str) -> bool:
    """Map a resolved kernel backend (ops/padded_targets.resolve_backend) to
    pallas_call's interpret flag: 'interpret' runs the kernel under the
    Pallas interpreter; 'pallas' is the compiled kernel, which exists only
    for the GPU — anything else is refused, never sent to the interpreter."""
    if backend == "interpret":
        return True
    if backend != "pallas":
        raise ValueError(f"the fused kernel runs as 'pallas' or 'interpret', "
                         f"not {backend!r}")
    if jax.default_backend() != "gpu":
        raise RuntimeError(
            "the fused trajectory kernel is compiled through Triton for a "
            f"GPU; the default backend is {jax.default_backend()!r}. Use "
            "backend='xla', or backend='interpret' to run the kernel under "
            "the Pallas interpreter")
    return False


def _scalars(step_size, gamma, steepness, extra=()):
    vals = [step_size, gamma, steepness, *extra]
    vals += [0.0] * (N_SCALARS - len(vals))
    return jnp.stack([jnp.asarray(v, jnp.float32) for v in vals])


def _bridge_operands(bridge, dim):
    """(beta, base_log_norm) scalars and the (1, dim) mean / 1/scale rows of
    the SMC bridge's spherical-Gaussian base."""
    beta, base_mean, base_scale = bridge
    bmean = jnp.broadcast_to(jnp.asarray(base_mean, jnp.float32), (dim,))
    bscale = jnp.broadcast_to(jnp.asarray(base_scale, jnp.float32), (dim,))
    base_log_norm = -jnp.sum(jnp.log(bscale)) - 0.5 * dim * math.log(TWO_PI)
    return ((beta, base_log_norm),
            (bmean[None, :], (1.0 / bscale)[None, :]))


def _metric_operand(inv_mass_matrix, dim):
    """Kernel operand for the metric: the (1, dim) diagonal row, or the
    zero-padded (d_pad, d_pad) dense M^{-1}."""
    if isinstance(inv_mass_matrix, PreparedDenseMetric):
        d_pad = block_dim(dim)
        if inv_mass_matrix.invm.shape != (d_pad, d_pad):
            raise ValueError(
                f"PreparedDenseMetric was built for d_pad "
                f"{inv_mass_matrix.invm.shape[0]}; dim {dim} needs {d_pad}")
        return inv_mass_matrix.invm
    invm = jnp.asarray(inv_mass_matrix, jnp.float32)
    if invm.ndim == 2:
        pad = block_dim(dim) - dim
        return jnp.pad(invm, ((0, pad), (0, pad)))
    return invm[None, :]


class _CallCache:
    """pallas_call objects per (n_chains, dim, metric kind, variant)."""

    def __init__(self, padded_vag_for, num_steps, friction_schedule,
                 interpret):
        self._vag_for = padded_vag_for
        self._args = (num_steps, friction_schedule)
        self._interpret = interpret
        self._calls = {}

    def __call__(self, n_chains, dim, dense, scaled, bridged):
        key = (n_chains, dim, dense, scaled, bridged)
        if key not in self._calls:
            self._calls[key] = _build_call(
                self._vag_for(dim), *self._args, n_chains, dim,
                self._interpret, dense=dense, scaled=scaled,
                bridged=bridged)
        return self._calls[key]


def _transition(calls, q, lp, grad, p0, u, step_size, gamma, steepness,
                inv_mass_matrix, lp_scale=None, bridge=None):
    """One kernel call on float32 operands. Returns the kernel's outputs
    (q', lp', grad', accept (float), delta_h, proposal q, proposal lp)."""
    n_chains, dim = q.shape
    scaled = lp_scale is not None
    bridged = bridge is not None
    if scaled and bridged:
        raise ValueError("lp_scale and bridge are mutually exclusive")
    extra, rows = (), ()
    if scaled:
        extra = (lp_scale,)
    if bridged:
        extra, rows = _bridge_operands(bridge, dim)
    call = calls(n_chains, dim, is_dense_metric(inv_mass_matrix), scaled,
                 bridged)
    f32 = jnp.float32
    return call(_scalars(step_size, gamma, steepness, extra),
                q.astype(f32), lp.astype(f32), grad.astype(f32),
                p0.astype(f32), u.astype(f32),
                _metric_operand(inv_mass_matrix, dim), *rows)


def draw_momentum(key, shape, inv_mass_matrix):
    """float32 p ~ N(0, M) for the kernel: z / sqrt(M^{-1}) for a diagonal
    metric, z L^{-1} for a dense one (see prepare_dense_metric)."""
    z = random.normal(key, shape, jnp.float32)
    if not is_dense_metric(inv_mass_matrix):
        return z / jnp.sqrt(jnp.asarray(inv_mass_matrix, jnp.float32))
    if isinstance(inv_mass_matrix, PreparedDenseMetric):
        _metric_operand(inv_mass_matrix, shape[1])      # validates its width
    else:
        inv_mass_matrix = prepare_dense_metric(inv_mass_matrix, shape[1])
    return jnp.dot(z, inv_mass_matrix.l_inv,
                   precision=lax.Precision.HIGHEST)


def _vag_cache(value_and_grad_fn):
    cache = {}

    def padded_vag_for(dim):
        if dim not in cache:
            cache[dim] = make_padded_vag(value_and_grad_fn, block_dim(dim))
        return cache[dim]
    return padded_vag_for


@memoize_on_target
def make_fused_grahmc_step(
    log_prob_fn,
    value_and_grad_fn,
    num_steps: int,
    friction_schedule: Optional[Callable],
    backend: str = "pallas",
):
    """Build a fused-step function with the grahmc_step calling convention:

        fused(key, state, step_size, gamma, steepness, inv_mass_matrix)
          -> (key, new_state, (accept, q_prop, lp_prop, delta_h))

    Requires a target with analytic pallas_info metadata for one of
    KERNEL_FAMILIES (mcmc_tpu.targets factories). The compiled kernel needs
    a GPU (backend='pallas'); backend='interpret' runs the same kernel under
    the Pallas interpreter (any platform, for tests).
    """
    if value_and_grad_fn is None:
        raise TypeError("the Pallas backend requires an analytic "
                        "value_and_grad_fn from mcmc_tpu.targets")
    calls = _CallCache(_vag_cache(value_and_grad_fn), num_steps,
                       friction_schedule, _interpret(backend))

    def fused(key, state, step_size, gamma, steepness, inv_mass_matrix,
              lp_scale=None, bridge=None):
        """lp_scale: optional runtime scalar multiplying the target's
        log-prob AND gradient in-kernel (a tempered replica samples
        pi^beta — samplers/tempered.py); None compiles the unscaled
        kernel.

        bridge: optional (beta, base_mean, base_scale) — the kernel then
        integrates the annealed-SMC geometric bridge
        beta*logp + (1-beta)*log N(base_mean, base_scale^2 I) with a
        RUNTIME beta (samplers/smc.py move phase); base_mean/base_scale
        are (dim,)-broadcastable. Mutually exclusive with lp_scale. The
        chain state's log_prob/grad_log_prob must already be the
        MIXTURE values at the current beta."""
        n_chains, dim = state.position.shape
        key, seed_key = random.split(key)
        k_mom, k_u = random.split(seed_key)
        p0 = draw_momentum(k_mom, (n_chains, dim), inv_mass_matrix)
        u = precision.accept_uniform(k_u, (n_chains,), jnp.float32)
        q1, lp1, grad1, acc, dh, prop_q, prop_lp = _transition(
            calls, state.position, state.log_prob, state.grad_log_prob, p0,
            u, step_size, gamma, steepness, inv_mass_matrix,
            lp_scale=lp_scale, bridge=bridge)

        accept = acc > 0.5
        divergent = jnp.abs(dh) > DIVERGENCE_DELTA_H
        pos_dtype = state.position.dtype
        e_dtype = state.log_prob.dtype
        new_state = state._replace(
            position=q1.astype(pos_dtype),
            log_prob=lp1.astype(e_dtype),
            grad_log_prob=grad1.astype(pos_dtype),
            accept_count=state.accept_count + accept.astype(jnp.int32),
            divergence_count=state.divergence_count + divergent.astype(jnp.int32),
        )
        # Proposal extras exactly mirror grahmc_step: the true trajectory
        # endpoint and its log-prob, regardless of the accept decision.
        return key, new_state, (accept, prop_q.astype(pos_dtype),
                                prop_lp.astype(e_dtype), dh.astype(e_dtype))

    return fused


def make_debug_trajectory(value_and_grad_fn, num_steps: int,
                          friction_schedule: Optional[Callable],
                          backend: str = "pallas"):
    """The fused transition with injected momentum and uniforms.

    Returns run(q, lp, grad, p0, u, step_size, gamma, steepness, inv_mass,
    bridge=None, lp_scale=None) -> (q', lp', grad', accept, delta_h) for
    comparison against the XLA trajectory on the same randomness.
    """
    calls = _CallCache(_vag_cache(value_and_grad_fn), num_steps,
                       friction_schedule, _interpret(backend))

    def run(q, lp, grad, p0, u, step_size, gamma, steepness, inv_mass,
            bridge=None, lp_scale=None):
        q1, lp1, grad1, acc, dh, _, _ = _transition(
            calls, q, lp, grad, p0, u, step_size, gamma, steepness, inv_mass,
            lp_scale=lp_scale, bridge=bridge)
        return q1, lp1, grad1, acc > 0.5, dh

    return run
