"""Stan-style windowed warmup: step-size DA + diagonal mass-matrix learning.

Behavioral parity with reference tuning/adaptation.py:
- schedule: exploration 500 + adaptation windows [25,50,100,200,500,1000] +
  cooldown 125 (total 2500),
- DA updated once per `update_freq`-step batch from the batch-mean acceptance
  statistic (mean trajectory alpha for NUTS),
- per-chain Welford during adaptation windows, end-of-window: average per-chain
  variances, shrink n/(n+5) toward identity, floor 1e-8, set inv mass, da_reset,
- GRAHMC: gamma tuned AFTER the mass matrix, on the sphered geometry, via
  sequential ESJD tuning (tuning/sequential.py),
- initial step 0.5/sqrt(d), final step = exp(log_step_bar).

Difference from the reference: each window runs as ONE jitted device computation — a
scan over batches with the DA state, Welford state and chain state in the
carry — instead of the reference's host loop that launches a sampler run and
re-jits DA math per 100 steps. Host round-trips happen only at window
boundaries (8 per warmup).
"""

import time
from functools import partial
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, random

from mcmc_tpu.samplers.base import make_value_and_grad, init_chain_state
from mcmc_tpu.tuning.welford import (
    WelfordState, welford_init, welford_update, chain_averaged_variance,
    shrink_variance, dense_moment_init, dense_moment_update,
    dense_covariance, shrink_covariance, psum_increment,
)
from mcmc_tpu.tuning.dual_averaging import (
    da_init, da_update, da_reset, da_step_size, da_final_step_size,
)


def build_schedule(
    num_steps: Optional[int] = None,
    exploration_steps: int = 500,
    adaptation_windows: Optional[list] = None,
    cooldown_steps: int = 125,
) -> list:
    """[(start, end, phase)] with phases exploration/adaptation/cooldown.

    Default totals 2500 = 500 + (25+50+100+200+500+1000) + 125.
    """
    if adaptation_windows is None:
        adaptation_windows = [25, 50, 100, 200, 500, 1000]

    schedule = []
    start = 0
    schedule.append((start, start + exploration_steps, "exploration"))
    start += exploration_steps
    for w in adaptation_windows:
        schedule.append((start, start + w, "adaptation"))
        start += w
    schedule.append((start, start + cooldown_steps, "cooldown"))
    start += cooldown_steps

    if num_steps is not None and start != num_steps:
        print(f"Warning: computed warmup ({start}) != num_steps ({num_steps}); "
              f"using computed schedule")
    return schedule


def fixed_width_batches(window_len: int, batch_width: int):
    """Yield (n_real, live_mask) fixed-width batches covering a window.

    Every batch has the SAME shape (batch_width,) so the whole warmup
    compiles one program per accumulate flag instead of one per window
    geometry; short windows and remainders pad with masked steps (the
    mask excludes them from the adaptation statistics). Shared by the
    windowed and the ChEES warmup drivers. A window not divisible by
    batch_width gets one extra DA update on its remainder batch."""
    B = max(1, int(batch_width))
    remaining = int(window_len)
    while remaining > 0:
        n_real = min(B, remaining)
        remaining -= n_real
        yield n_real, jnp.asarray(np.arange(B) < n_real)


def _persistent_accept_stat(d_alpha, d_transitions, fallback=0.65,
                            axis_name=None):
    """Batch acceptance statistic from per-chain accumulator deltas.

    Mean of per-chain mean-alpha over chains that completed >= 1 transition
    this step; `fallback` when no chain finished a trajectory yet. With
    `axis_name` (shard_map
    warmup under a chain mesh) the numerator/denominator sums are psum'd so
    the statistic is exactly the global one and the replicated DA state stays
    bit-identical on every device.
    """
    valid = d_transitions > 0
    per_chain = jnp.where(valid, d_alpha / jnp.maximum(d_transitions, 1.0),
                          0.0)
    num = jnp.sum(per_chain)
    den = jnp.sum(valid.astype(per_chain.dtype))
    if axis_name is not None:
        num = lax.psum(num, axis_name)
        den = lax.psum(den, axis_name)
    stat = num / jnp.maximum(den, 1.0)
    return jnp.where(den > 0, stat, jnp.asarray(fallback, per_chain.dtype))


def _make_step_fn(sampler: str, log_prob_fn, value_and_grad_fn, kwargs,
                  schedule_type, gamma, steepness, backend: str = "xla",
                  axis_name: Optional[str] = None):
    """Build the warmup stepping quadruple:

        (step, make_state, get_position, state_chain_axis)

    step: (key, state, step_size, inv_mass) -> (key, state, accept_stat);
    make_state: (initial_position) -> state pytree carried through the
    window scans; get_position: state -> (n_chains, dim) for Welford and the
    returned warmed position; state_chain_axis: which axis of every state
    leaf is the chain axis ('leading' for ChainState/_PState) — used to
    build shard_map specs for mesh warmup. Classic samplers use ChainState; persistent NUTS carries its
    asynchronous machine state instead (one warmup "step" advances
    `steps_per_warmup_step` global leapfrog iterations). With `axis_name`
    the accept statistic is reduced over the named mesh axis so it is the
    global batch statistic on every device."""
    vag = make_value_and_grad(log_prob_fn, value_and_grad_fn)

    def _mean_stat(accept):
        stat = jnp.mean(accept)
        if axis_name is not None:
            stat = lax.pmean(stat, axis_name)
        return stat

    def _chain_state(pos):
        return init_chain_state(pos, log_prob_fn, value_and_grad_fn,
                                needs_grad=True)

    def _classic(step):
        return step, _chain_state, lambda s: s.position, "leading"

    if sampler == "nuts" and backend == "persistent":
        from mcmc_tpu import precision
        from mcmc_tpu.samplers.nuts_persistent import (
            _init_pstate, _make_window_step)
        max_tree_depth = kwargs.get("max_tree_depth", 10)
        G = kwargs.get("steps_per_warmup_step", 32)
        # warmup runs the SAME proposal scheme as sampling (the multinomial
        # machine also terminates on sub-U-turns / per-leaf divergences, so
        # step/mass adapt to the dynamics phase 2 will actually run)
        scheme = kwargs.get("nuts_proposal", "endpoint")
        multinomial = scheme == "multinomial"

        if value_and_grad_fn is not None:
            vag_b = value_and_grad_fn
        else:
            vag_b = jax.vmap(jax.value_and_grad(log_prob_fn))

        def make_state(pos):
            e_dtype = precision.energy_dtype()
            cs = _chain_state(pos)
            return _init_pstate(cs.position,
                                jnp.asarray(cs.log_prob, e_dtype),
                                cs.grad_log_prob, e_dtype,
                                multinomial=multinomial,
                                max_tree_depth=max_tree_depth)

        def step(key, ps, step_size, inv_mass):
            e_dtype = ps.sum_alpha.dtype
            wstep = _make_window_step(vag_b, step_size,
                                      jnp.asarray(inv_mass, ps.q.dtype),
                                      max_tree_depth, 1000.0, e_dtype,
                                      proposal_scheme=scheme)
            key, sub = random.split(key)
            C, D = ps.q.shape
            kp, kd, kd2, ks, ku, kr = random.split(sub, 6)
            xs = (random.normal(kp, (G, C, D), ps.q.dtype),
                  random.bernoulli(kd, 0.5, (G, C)),
                  random.bernoulli(kd2, 0.5, (G, C)),
                  random.uniform(ks, (G, C)),
                  random.uniform(ku, (G, C), dtype=jnp.float32,
                                 minval=jnp.finfo(jnp.float32).tiny),
                  random.uniform(kr, (G, C)))
            a0, t0 = ps.alpha_acc, ps.transitions
            ps = lax.scan(wstep, ps, xs)[0]
            stat = _persistent_accept_stat(
                (ps.alpha_acc - a0).astype(e_dtype),
                (ps.transitions - t0).astype(e_dtype),
                axis_name=axis_name)
            return key, ps, stat
        return step, make_state, lambda s: s.q, "leading"

    if sampler == "hmc":
        from mcmc_tpu.samplers.hmc import hmc_step
        num_steps = kwargs.get("num_steps", 20)

        def step(key, state, step_size, inv_mass):
            key, state, (accept, *_r) = hmc_step(key, state, vag, step_size,
                                                 num_steps, inv_mass)
            return key, state, _mean_stat(accept)
        return _classic(step)

    if sampler in ("grahmc", "rahmc"):
        from mcmc_tpu.samplers.grahmc import grahmc_step, get_friction_schedule
        num_steps = kwargs.get("num_steps", 20)
        schedule_fn = get_friction_schedule(schedule_type or "constant")

        if backend != "xla":
            from mcmc_tpu.ops.fused_trajectory import make_fused_grahmc_step
            fused = make_fused_grahmc_step(log_prob_fn, value_and_grad_fn,
                                           num_steps, schedule_fn,
                                           backend=backend)

            def step(key, state, step_size, inv_mass):
                key, state, (accept, *_r) = fused(
                    key, state, step_size, gamma, steepness, inv_mass)
                return key, state, _mean_stat(accept)
            return _classic(step)

        def step(key, state, step_size, inv_mass):
            key, state, (accept, *_r) = grahmc_step(
                key, state, vag, step_size, num_steps, gamma, steepness,
                inv_mass, schedule_fn)
            return key, state, _mean_stat(accept)
        return _classic(step)

    if sampler == "nuts":
        from mcmc_tpu.samplers.nuts import nuts_step
        max_tree_depth = kwargs.get("max_tree_depth", 10)
        vag_single = (value_and_grad_fn if value_and_grad_fn is not None
                      else jax.value_and_grad(log_prob_fn))

        def step(key, state, step_size, inv_mass):
            key, state, (depths, mean_alpha) = nuts_step(
                key, state, vag_single, step_size, inv_mass, max_tree_depth)
            # NUTS acceptance statistic = mean trajectory alpha
            return key, state, _mean_stat(mean_alpha)
        return _classic(step)

    raise ValueError(f"Unknown sampler: {sampler}")


def _state_pspec(state, chain_axis: str):
    """PartitionSpec pytree for a warmup chain-state: every non-scalar leaf
    shards its leading chain axis (ChainState/_PState/Welford arrays);
    scalars replicate.
    The pooled DenseMomentState has NO chain axis (its leaves are (D,) /
    (D, D) global sums, kept replicated by per-step psums in _batch_body),
    so every leaf replicates."""
    from jax.sharding import PartitionSpec as P
    from mcmc_tpu.parallel import CHAIN_AXIS
    from mcmc_tpu.tuning.welford import DenseMomentState

    if isinstance(state, DenseMomentState):
        return jax.tree.map(lambda _: P(), state)

    def spec(leaf):
        nd = jnp.ndim(leaf)
        if nd == 0:
            return P()
        return P(CHAIN_AXIS, *([None] * (nd - 1)))
    return jax.tree.map(spec, state)


def _shard_warmup_state(mesh, keys, chain_state, welford, state_chain_axis):
    """Commit the warmup carry to the mesh: per-device key rows + chain-sharded
    state/Welford leaves (count stays replicated)."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    from mcmc_tpu.parallel import CHAIN_AXIS

    def put(tree, specs):
        return jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
            tree, specs)

    kspec = P(CHAIN_AXIS, *([None] * (jnp.ndim(keys) - 1)))
    return (jax.device_put(keys, NamedSharding(mesh, kspec)),
            put(chain_state, _state_pspec(chain_state, state_chain_axis)),
            put(welford, _state_pspec(welford, "leading")))


def _make_sharded_window_runner(mesh, batch_body, state_chain_axis):
    """shard_map wrapper around one fixed-width warmup batch: each device
    scans its local chain shard (the fused kernel included — pallas_call is
    opaque to GSPMD); the DA state is replicated and stays bit-identical
    everywhere because the accept statistics inside `batch_body` are psum'd
    globally. The step mask is replicated (same padding on every device)."""
    from jax.sharding import PartitionSpec as P
    from mcmc_tpu.parallel import CHAIN_AXIS, shard_map_fn

    @partial(jax.jit, static_argnames=("accumulate",))
    def run_batch(keys, chain_state, da_state, welford, inv_mass, mask,
                  accumulate: bool):
        kspec = P(CHAIN_AXIS, *([None] * (jnp.ndim(keys) - 1)))
        state_specs = _state_pspec(chain_state, state_chain_axis)
        wf_specs = _state_pspec(welford, "leading")
        da_specs = jax.tree.map(lambda _: P(), da_state)
        common = (kspec, state_specs, da_specs, wf_specs)
        in_specs = common + (P(), P())
        out_specs = common + (P(),)      # batch accept stat: replicated

        def inner(keys, cs, da, wf, im, mask):
            key, cs, da, wf, acc = batch_body(
                keys[0], cs, da, wf, im, mask, accumulate)
            return key[None], cs, da, wf, acc

        return shard_map_fn(inner, mesh, in_specs=in_specs,
                            out_specs=out_specs)(
            keys, chain_state, da_state, welford, inv_mass, mask)
    return run_batch


def run_adaptive_warmup(
    sampler: str,
    target_log_prob,
    target_grad_log_prob,          # kept for API parity; analytic grads via value_and_grad_fn
    initial_position: jnp.ndarray,
    key: jnp.ndarray,
    num_warmup: int = 1000,
    target_accept: float = 0.65,
    schedule_type: Optional[str] = None,
    update_freq: int = 100,
    learn_mass_matrix: bool = True,
    value_and_grad_fn=None,
    verbose: bool = False,
    backend: str = "auto",
    mesh=None,
    **kwargs,
) -> Tuple[float, Optional[jnp.ndarray], jnp.ndarray, Dict]:
    """Windowed warmup. Returns (step_size, inv_mass_matrix, position, info).

    backend: 'pallas' ('interpret') runs GRAHMC warmup steps through the
    fused trajectory kernel (under the Pallas interpreter); 'auto' follows
    ops/padded_targets.resolve_backend; 'persistent' selects the
    asynchronous NUTS machine.

    mesh: a chain `Mesh` routes every window scan through shard_map — each
    device advances its local chain shard (pallas_call is opaque to GSPMD,
    so explicit shard_map is the only way to run the fused kernel
    multi-chip); the DA/Welford feedback uses psum'd global
    statistics, so the replicated DA state is bit-identical on every device
    and the learned mass matrix equals the single-device one up to RNG
    streams (VERDICT r2 #3 — previously multi-chip warmup fell back to
    GSPMD-partitioned XLA scans)."""
    n_chains, n_dim = initial_position.shape
    start_time = time.time()

    # learn_mass_matrix: False (identity), True (diagonal, reference
    # parity), or "dense" (full covariance metric — beyond-reference,
    # Stan's dense_e).
    # Every warmup path is dense-capable: the XLA machines are
    # metric-polymorphic and the fused trajectory kernel takes the (D, D)
    # metric as an operand.
    dense_mass = learn_mass_matrix == "dense"

    if backend != "persistent":
        from mcmc_tpu.ops.padded_targets import resolve_backend
        backend = (resolve_backend(backend, value_and_grad_fn)
                   if sampler in ("grahmc", "rahmc") else "xla")

    if sampler in ("grahmc", "rahmc"):
        gamma = kwargs.get("gamma", 1.0)
        steepness = kwargs.get("steepness", 0.5 if schedule_type == "tanh" else 2.0)
    else:
        gamma = steepness = None

    if mesh is not None:
        from mcmc_tpu.parallel import CHAIN_AXIS
        axis_name = CHAIN_AXIS
    else:
        axis_name = None

    step_fn, make_state, get_position, state_chain_axis = _make_step_fn(
        sampler, target_log_prob, value_and_grad_fn, kwargs,
        schedule_type, gamma, steepness, backend, axis_name=axis_name)

    def _batch_body(key, chain_state, da_state, welford, inv_mass, mask,
                    accumulate):
        """One DA batch at the UNIFORM shape (update_freq,), fully on
        device. Every window is stepped in fixed-width batches (short
        windows and remainders pad with masked steps), so the whole warmup
        compiles exactly TWO programs per process (accumulate on/off)
        instead of one per distinct window geometry, each of which would
        pay a full XLA compile. A masked
        step still advances the chains (a valid transition, excluded from
        the DA/Welford statistics)."""
        step_size = da_step_size(da_state)

        def step_body(inner, live):
            k, s, w = inner
            k, s, accept_stat = step_fn(k, s, step_size, inv_mass)
            if accumulate:
                update = dense_moment_update if dense_mass else welford_update
                w_new = update(w, get_position(s))
                if dense_mass and axis_name is not None:
                    # pooled sums over the GLOBAL chains: psum the local
                    # increment so the replicated carry stays bit-identical
                    # on every device (the diagonal Welford state is
                    # per-chain and shards instead)
                    w_new = psum_increment(w_new, w, axis_name)
                w = jax.tree.map(
                    lambda a, b: jnp.where(live, a, b), w_new, w)
            return (k, s, w), accept_stat

        (key, chain_state, welford), accepts = lax.scan(
            step_body, (key, chain_state, welford), mask)
        w = mask.astype(accepts.dtype)
        acc = jnp.sum(accepts * w) / jnp.maximum(jnp.sum(w), 1.0)
        da_state = da_update(da_state, acc, target_accept)
        return key, chain_state, da_state, welford, acc

    if mesh is None:
        @partial(jax.jit, static_argnames=("accumulate",))
        def run_batch(key, chain_state, da_state, welford, inv_mass, mask,
                      accumulate: bool):
            return _batch_body(key, chain_state, da_state, welford,
                               inv_mass, mask, accumulate)
    else:
        run_batch = _make_sharded_window_runner(
            mesh, _batch_body, state_chain_axis)

    # --- initial state ---------------------------------------------------
    initial_step = 0.5 / float(jnp.sqrt(n_dim))
    da_state = da_init(initial_step)
    chain_state = make_state(initial_position)
    if dense_mass:
        # identity as a dense matrix + a dense accumulator from the start:
        # the carry/operand SHAPES stay uniform for the whole warmup, so
        # the fixed-shape compile discipline (two run_batch programs)
        # holds for dense runs too (the placeholder accumulator is
        # re-initialized with a real center at each adaptation window)
        inv_mass = jnp.eye(n_dim, dtype=initial_position.dtype)
        welford = dense_moment_init(
            jnp.zeros(n_dim, dtype=initial_position.dtype))
    else:
        inv_mass = jnp.ones(n_dim, dtype=initial_position.dtype)
        welford = welford_init((n_chains, n_dim))
    if mesh is not None:
        # distinct per-device key streams, carried sharded over the mesh
        key = random.split(key, mesh.devices.size)
        key, chain_state, welford = _shard_warmup_state(
            mesh, key, chain_state, welford, state_chain_axis)

    schedule = build_schedule(
        num_warmup,
        exploration_steps=kwargs.get("exploration_steps", 500),
        adaptation_windows=kwargs.get("adaptation_windows"),
        cooldown_steps=kwargs.get("cooldown_steps", 125))
    if verbose:
        print(f"Adaptation schedule ({sum(e - s for s, e, _ in schedule)} steps):")
        for s, e, t in schedule:
            print(f"  [{s:4d} - {e:4d}] {t}")
        if not learn_mass_matrix:
            print("  [mass matrix learning disabled - identity metric]")

    accept_trace = []
    # --- windowed adaptation (fixed-width DA batches, see _batch_body) ----
    for start_idx, end_idx, phase in schedule:
        window_len = end_idx - start_idx
        accumulate = phase == "adaptation" and bool(learn_mass_matrix)
        if accumulate:
            if dense_mass:
                welford = dense_moment_init(
                    jnp.mean(get_position(chain_state), axis=0))
            else:
                welford = welford_init((n_chains, n_dim))

        for _n_real, mask in fixed_width_batches(window_len, update_freq):
            key, chain_state, da_state, welford, acc = run_batch(
                key, chain_state, da_state, welford, inv_mass, mask,
                accumulate=accumulate)
            # device scalar, converted after the loop: a float() here
            # would block on a device->host round trip per batch
            accept_trace.append(acc)

        if accumulate:
            if dense_mass:
                cov = dense_covariance(welford)
                inv_mass = shrink_covariance(
                    cov, welford.count / n_chains).astype(
                        initial_position.dtype)
            else:
                variance = chain_averaged_variance(welford)
                inv_mass = shrink_variance(variance, welford.count).astype(
                    initial_position.dtype)
            da_state = da_reset(da_state)
            if verbose:
                n_pc = float(welford.count) / (n_chains if dense_mass else 1)
                print(f"  window [{start_idx}-{end_idx}]: mass matrix range "
                      f"[{float(jnp.min(inv_mass)):.4f}, {float(jnp.max(inv_mass)):.4f}]"
                      f" (n={n_pc:.0f}/chain)")

    accept_trace = [float(a) for a in accept_trace]
    final_step_size = float(da_final_step_size(da_state))
    position = get_position(chain_state)
    if verbose:
        print(f"Warmup complete. Final step_size: {final_step_size:.5f}")

    # --- GRAHMC phase 3: friction tuning on the sphered geometry ----------
    if sampler in ("grahmc", "rahmc"):
        from mcmc_tpu.tuning.sequential import sequential_tune_grahmc
        tuned_step, tuned_gamma, tuned_steepness, tune_history = sequential_tune_grahmc(
            key=random.fold_in(key[0] if mesh is not None else key, 999),
            log_prob_fn=target_log_prob,
            grad_log_prob_fn=target_grad_log_prob,
            init_position=position,
            num_steps=kwargs.get("num_steps", 20),
            schedule_type=schedule_type or "constant",
            target_accept=target_accept,
            max_iter_step=kwargs.get("max_iter_step", 1000),
            inv_mass_matrix=inv_mass,
            init_step_size=final_step_size,
            gamma_coarse_values=kwargs.get("gamma_coarse_values"),
            gamma_samples_per_eval=kwargs.get("gamma_samples_per_eval", 150),
            value_and_grad_fn=value_and_grad_fn,
            verbose=verbose,
            # Under a mesh the tuner's DA/ESJD probes run shard_mapped with
            # the same backend as the windows (fused kernel per device,
            # pmean'd feedback) — no XLA fallback anywhere in mesh warmup.
            backend=backend,
            mesh=mesh,
        )
        gamma, steepness, final_step_size = tuned_gamma, tuned_steepness, tuned_step
        if verbose:
            print(f"  friction tuned: gamma={gamma:.5f} steepness={steepness:.3f} "
                  f"step={final_step_size:.5f}")

    info: Dict[str, Any] = {
        "elapsed_time": time.time() - start_time,
        "final_step_size": final_step_size,
        "inv_mass_matrix": inv_mass,
        "mass_matrix_learned": learn_mass_matrix,
        "accept_trace": accept_trace,
    }
    if sampler in ("grahmc", "rahmc"):
        info["gamma"] = float(gamma) if gamma is not None else 1.0
        info["steepness"] = float(steepness) if steepness is not None else 5.0

    # inv_mass is still the identity when learning was disabled (adaptation
    # windows never accumulate in that case).
    return final_step_size, inv_mass, position, info
