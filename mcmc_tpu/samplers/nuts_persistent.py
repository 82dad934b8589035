"""Persistent (asynchronous) NUTS: the lockstep-free batched machine.

The classic batched NUTS (`mcmc_tpu.samplers.nuts`) mirrors the reference's
vmapped iterative doubling (reference samplers/NUTS.py:380-442): all chains
double their trees in lockstep, so every chain pays for the deepest tree in
the batch. With 4096 chains on the 50D funnel that lockstep tax ("stall
factor" = executed/useful leapfrogs, a count that does not depend on the
device) is 8.7x at step=0.05 and 32x at step=0.2 — transitions/s is flat in
step size because the deepest chain always hits the depth cap.

This module removes the synchronization entirely. The transition is flattened
into a per-chain state machine advanced ONE leapfrog per global iteration:

  - every chain takes exactly one (masked) leapfrog per iteration — uniform
    SIMD work, no nested data-dependent loops;
  - when a chain finishes its current subtree it does the doubling
    bookkeeping (endpoint-validity proposal swap, U-turn test) in-place via
    where-selects;
  - when its trajectory terminates it IMMEDIATELY begins its next transition
    (fresh momentum/slice variable) — chains never wait for each other;
  - samples are emitted once every `steps_per_sample` global iterations.
    The default `snapshot_mode="uniform"` emits a reservoir-sampled state:
    a uniformly-chosen completed transition from the window, which matches
    the classic/reference per-transition statistics (each transition counted
    once). `snapshot_mode="last"` emits the chain's last *completed* state
    instead — a deterministic-TIME snapshot, which is length-biased: in
    steady state a completed state x is the "latest" with probability
    proportional to pi(x) * E[tau(x)], tau = leapfrog count of the next
    transition from x, NOT pi(x) alone. Measured on the 4D standard normal
    at step 0.5 (mean depth 2.9): "last" underdisperses ~1.5% on top of the
    endpoint-only tree scheme's own ~3% (which the reference shares —
    verified against /root/reference/samplers/NUTS.py on the identical
    config); "uniform" removes the occupancy part. Windows with zero
    completions fall back to the last completed state.

Randomness is pre-drawn per snapshot window and fed through `lax.scan` xs, so
the hot loop contains no threefry work.

Semantics parity with the reference transition (NUTS.py:201-396), verified by
the same statistical gates as the classic path:
  - subtree validity checked only at the subtree ENDPOINT; a valid endpoint
    counts the whole 2^depth subtree (reference NUTS.py:319-336),
  - acceptance statistic alpha = exp(min(0, h0 - h)) accumulated over ALL
    integration steps, Stan-style (reference NUTS.py:161-181),
  - slice variable log u = log U(0,1) - h0; divergence when h - h0 > delta_max
    (default 1000); NaN per-transition mean-accept falls back to 0.65,
  - U-turn when (q_right - q_left) . p_left < 0 or . p_right < 0,
  - termination condition ordering matches the reference while_loop cond.
"""

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax, random

from mcmc_tpu import precision
from mcmc_tpu.samplers.base import ChainState, RunResult, init_chain_state
from mcmc_tpu.samplers.trajectory import kinetic_energy, velocity

Array = jnp.ndarray


class _PState(NamedTuple):
    """Batched per-chain persistent-NUTS machine state (leading axis = chains)."""
    # last completed sample (the chain's current state)
    q: Array
    lp: Array
    grad: Array
    # trajectory endpoints
    q_l: Array
    p_l: Array
    g_l: Array
    q_r: Array
    p_r: Array
    g_r: Array
    # running proposal
    q_prop: Array
    lp_prop: Array
    g_prop: Array
    # advancing endpoint (its log-prob is recomputed by the leapfrog)
    q_c: Array
    p_c: Array
    g_c: Array
    # per-transition scalars
    h0: Array
    log_u: Array
    n_valid: Array      # int32
    sum_alpha: Array    # energy dtype
    n_steps: Array      # int32, steps taken in current trajectory
    depth: Array        # int32, current subtree depth
    steps_left: Array   # int32, leapfrogs left in current subtree
    direction: Array    # position dtype, +/-1
    diverged: Array     # bool, any divergent subtree endpoint this transition
    needs_start: Array  # bool, start a fresh transition this iteration
    # accumulators (across transitions)
    transitions: Array        # int32 per chain
    divergences: Array        # int32 per chain
    alpha_acc: Array          # sum of per-transition mean-alpha
    depth_acc: Array          # int32, sum of terminal depths
    # snapshot reservoir: a uniformly-chosen completed transition of the
    # current window (k_res completions so far; see nuts_run_persistent's
    # snapshot_mode for why deterministic-time "last completed" is biased)
    q_res: Array
    lp_res: Array
    k_res: Array              # int32, completions this window
    # multinomial proposal scheme only (None under the endpoint scheme):
    # running subtree proposal + log weights (Betancourt 2017, Stan's
    # default) — see _make_window_step's proposal_scheme
    q_sub: Optional[Array] = None
    lp_sub: Optional[Array] = None
    g_sub: Optional[Array] = None
    lw_tree: Optional[Array] = None   # log sum of e^{h0-h} over the tree
    lw_sub: Optional[Array] = None    # ... over the current subtree
    div_sub: Optional[Array] = None   # bool, any divergent LEAF this subtree
    turn_sub: Optional[Array] = None  # bool, any internal U-turn this subtree
    # iterative-NUTS checkpoint stacks, (C, max_tree_depth, D): state of
    # every live aligned-block start within the current subtree, enabling
    # the FULL recursive U-turn check set without recursion (see
    # _make_window_step's proposal_scheme notes)
    q_stk: Optional[Array] = None
    p_stk: Optional[Array] = None


def _init_pstate(q, lp, grad, e_dtype, multinomial: bool = False,
                 max_tree_depth: int = 10):
    C, D = q.shape
    z = jnp.zeros((C,), e_dtype)
    zi = jnp.zeros((C,), jnp.int32)
    extra = {}
    if multinomial:
        stk = jnp.zeros((C, max_tree_depth, D), q.dtype)
        extra = dict(q_sub=q, lp_sub=lp, g_sub=grad, lw_tree=z, lw_sub=z,
                     div_sub=jnp.zeros((C,), bool),
                     turn_sub=jnp.zeros((C,), bool),
                     q_stk=stk, p_stk=stk)
    return _PState(
        q=q, lp=lp, grad=grad,
        q_l=q, p_l=jnp.zeros_like(q), g_l=grad,
        q_r=q, p_r=jnp.zeros_like(q), g_r=grad,
        q_prop=q, lp_prop=lp, g_prop=grad,
        q_c=q, p_c=jnp.zeros_like(q), g_c=grad,
        h0=z, log_u=z, n_valid=zi, sum_alpha=z, n_steps=zi,
        depth=zi, steps_left=zi,
        direction=jnp.ones((C,), q.dtype),
        diverged=jnp.zeros((C,), bool),
        needs_start=jnp.ones((C,), bool),
        transitions=zi, divergences=zi, alpha_acc=z, depth_acc=zi,
        q_res=q, lp_res=lp, k_res=zi, **extra,
    )


def _make_window_step(value_and_grad_batched, step_size, inv_mass,
                      max_tree_depth, delta_max, e_dtype,
                      proposal_scheme: str = "endpoint"):
    """One global iteration: (state, (p0, dir_bit, swap_u, slice_u)) -> state.

    value_and_grad_batched: (C, D) -> ((C,), (C, D)).

    The metric is diagonal (inv_mass shape (D,), reference parity) or dense
    (shape (D, D), Stan's dense_e — a beyond-reference extension). Dense adds
    one (C, D) @ (D, D) matmul per leapfrog (velocity) and one unwhitening
    solve per iteration's momentum refresh (against a loop-invariant
    Cholesky factor that XLA hoists out of the window scan); the U-turn
    test stays the raw-momentum dq.p for both metrics (see the in-line
    note below).

    proposal_scheme selects how the transition's proposal is drawn from the
    trajectory:
      - 'endpoint' (default): reference parity — subtree validity checked
        only at the subtree ENDPOINT, a valid endpoint counts the whole
        2^depth subtree, and only endpoint states are proposable (reference
        NUTS.py:319-336). Measurably underdispersed: marginal variance
        0.967 vs 1.0 on the 4D standard normal at mean depth ~3, identical
        to the reference (BASELINE.md bias audit #1).
      - 'multinomial': per-LEAF progressive multinomial weighting
        (Betancourt 2017 §A.4, Stan's default scheme). Every leapfrog's
        state enters a weighted reservoir with weight e^{h0-h} (exactly
        multinomial over the subtree's leaves), subtrees merge into the
        trajectory proposal via the biased swap
        P(take subtree) = min(1, W_sub/W_tree), a divergent LEAF (not just
        endpoint) poisons its subtree (weight excluded, trajectory
        terminates), and the FULL recursive sub-U-turn check set runs via
        the iterative checkpoint-stack formulation (see the in-line note) —
        textbook semantics, unlike the reference. Cost: 3 extra (C, D)
        state arrays + 2 (C, max_tree_depth, D) checkpoint stacks + 4
        scalars per chain; one extra uniform stream is reused from the
        (unused) slice stream.
    """
    multinomial = proposal_scheme == "multinomial"
    if not multinomial and proposal_scheme != "endpoint":
        raise ValueError(f"unknown proposal_scheme: {proposal_scheme!r}")
    delta_max = jnp.asarray(delta_max, e_dtype)
    dense = inv_mass.ndim == 2
    if dense:
        from jax.scipy.linalg import solve_triangular
        # p ~ N(0, M): with M^{-1} = L L^T, p = z L^{-1} has covariance
        # L^{-T} L^{-1} = M. The factor is loop-invariant; XLA hoists the
        # solve out of the window scan.
        chol = jnp.linalg.cholesky(inv_mass)
        l_inv = solve_triangular(
            chol, jnp.eye(inv_mass.shape[0], dtype=inv_mass.dtype),
            lower=True)

        def unwhiten(z):
            return z @ l_inv
    else:
        def unwhiten(z):
            return z / jnp.sqrt(inv_mass)

    def step(s: _PState, xs):
        # dir_bit seeds a fresh transition's first direction; dir2_bit picks
        # the next doubling's direction — independent streams, because a chain
        # can both start and extend its tree within one iteration. res_u
        # drives the snapshot reservoir (consumed only at term events).
        p0_row, dir_bit, dir2_bit, swap_u, slice_u, res_u = xs
        pos_dtype = s.q.dtype
        w = lambda m, a, b: jnp.where(m[:, None], a, b)   # (C,) mask over (C,D)

        # --- 1. fresh-transition init (chains flagged needs_start) --------
        st = s.needs_start
        p0 = unwhiten(p0_row)
        h0_new = (-s.lp + kinetic_energy(p0, inv_mass).astype(e_dtype))
        log_u_new = jnp.log(slice_u).astype(e_dtype) - h0_new
        dir_new = jnp.where(dir_bit, 1.0, -1.0).astype(pos_dtype)

        s = s._replace(
            q_l=w(st, s.q, s.q_l), p_l=w(st, p0, s.p_l), g_l=w(st, s.grad, s.g_l),
            q_r=w(st, s.q, s.q_r), p_r=w(st, p0, s.p_r), g_r=w(st, s.grad, s.g_r),
            q_prop=w(st, s.q, s.q_prop),
            lp_prop=jnp.where(st, s.lp, s.lp_prop),
            g_prop=w(st, s.grad, s.g_prop),
            q_c=w(st, s.q, s.q_c), p_c=w(st, p0, s.p_c),
            g_c=w(st, s.grad, s.g_c),
            h0=jnp.where(st, h0_new, s.h0),
            log_u=jnp.where(st, log_u_new, s.log_u),
            n_valid=jnp.where(st, 1, s.n_valid),
            sum_alpha=jnp.where(st, jnp.asarray(0.0, e_dtype), s.sum_alpha),
            n_steps=jnp.where(st, 0, s.n_steps),
            depth=jnp.where(st, 0, s.depth),
            steps_left=jnp.where(st, 1, s.steps_left),
            direction=jnp.where(st, dir_new, s.direction),
            diverged=jnp.where(st, False, s.diverged),
            needs_start=jnp.zeros_like(st),
        )
        if multinomial:
            neg_inf = jnp.asarray(-jnp.inf, e_dtype)
            s = s._replace(
                q_sub=w(st, s.q, s.q_sub),
                lp_sub=jnp.where(st, s.lp, s.lp_sub),
                g_sub=w(st, s.grad, s.g_sub),
                # the initial state is the root tree with weight e^0 = 1
                lw_tree=jnp.where(st, jnp.asarray(0.0, e_dtype), s.lw_tree),
                lw_sub=jnp.where(st, neg_inf, s.lw_sub),
                div_sub=jnp.where(st, False, s.div_sub),
                turn_sub=jnp.where(st, False, s.turn_sub),
            )

        # --- 2. one leapfrog for every chain ------------------------------
        eps = (s.direction * jnp.asarray(step_size, pos_dtype))[:, None]
        p = s.p_c + 0.5 * eps * s.g_c
        q = s.q_c + eps * velocity(p, inv_mass)
        lp, grad = value_and_grad_batched(q)
        lp = jnp.asarray(lp, e_dtype)
        grad = grad.astype(pos_dtype)
        p = p + 0.5 * eps * grad
        h = -lp + kinetic_energy(p, inv_mass).astype(e_dtype)
        alpha = jnp.exp(jnp.minimum(jnp.asarray(0.0, e_dtype), s.h0 - h))
        s = s._replace(
            q_c=q, p_c=p, g_c=grad,
            sum_alpha=s.sum_alpha + alpha,
            n_steps=s.n_steps + 1,
            steps_left=s.steps_left - 1,
        )

        if multinomial:
            # per-leaf weighted reservoir over the current subtree: replace
            # the subtree proposal w.p. w_leaf / W_sub-so-far — marginally
            # exactly multinomial among the subtree's leaves. The slice
            # stream (unused by this scheme) supplies the uniform.
            lw_leaf = jnp.where(jnp.isfinite(h), s.h0 - h,
                                jnp.asarray(-jnp.inf, e_dtype))
            div_leaf = ~jnp.isfinite(h) | ((h - s.h0) > delta_max)
            lw_sub_new = jnp.logaddexp(s.lw_sub, lw_leaf)
            # -inf - -inf = nan: the comparison is then False, as required
            take_leaf = slice_u < jnp.exp(lw_leaf - lw_sub_new)
            # full iterative sub-U-turn recursion (the checkpoint-stack
            # formulation of Stan's recursive build_tree checks; Phan &
            # Pradhan's iterative NUTS). Within the current subtree, leaf
            # index i (0-based): even leaves STORE their state at stack
            # slot popcount(i >> 1); odd leaves CHECK the U-turn criterion
            # against every live aligned-block start — slots
            # [popcount(i>>1) - trailing_ones(i) + 1 .. popcount(i>>1)],
            # exactly the recursion's check set (block [k 2^j, (k+1) 2^j - 1]
            # fires at its last leaf against its first). A subtree with ANY
            # internal U-turn is INVALID — discarded whole (no swap, no
            # weight merge) and the trajectory terminates, matching Stan's
            # valid_subtree semantics. Without these checks the
            # u-turn-causing final subtree (whose leaves sit at the
            # trajectory's turning points — extreme |q|) merges with
            # ~min(1, W_sub/W_tree) probability and the chain OVERdisperses
            # (measured +7.5% marginal variance on the 4D standard normal;
            # top-level-only checking still leaves -2.3%).
            i_leaf = (jnp.int32(1) << s.depth) - s.steps_left - 1
            even = (i_leaf & 1) == 0
            slot = lax.population_count(i_leaf >> 1)
            t_ones = lax.population_count(i_leaf ^ (i_leaf + 1)) - 1
            srange = jnp.arange(s.q_stk.shape[1], dtype=jnp.int32)[None, :]
            store = even[:, None] & (srange == slot[:, None])   # (C, S)
            q_stk = jnp.where(store[..., None], q[:, None, :], s.q_stk)
            p_stk = jnp.where(store[..., None], p[:, None, :], s.p_stk)
            check = (~even[:, None]
                     & (srange >= (slot - t_ones + 1)[:, None])
                     & (srange <= slot[:, None]))                # (C, S)
            # the HG criterion needs the SPATIAL right-minus-left
            # displacement; a backward-built subtree's current leaf is
            # spatially LEFT of its checkpoints, so orient by the subtree's
            # integration direction (constant within a subtree). Both
            # endpoint momenta are OR-checked, so their labeling is free.
            dq_all = ((q[:, None, :] - q_stk)
                      * s.direction[:, None, None])              # (C, S, D)
            turning = check & (
                (jnp.sum(dq_all * p_stk, axis=-1) < 0)
                | (jnp.sum(dq_all * p[:, None, :], axis=-1) < 0))
            s = s._replace(
                q_sub=w(take_leaf, q, s.q_sub),
                lp_sub=jnp.where(take_leaf, lp, s.lp_sub),
                g_sub=w(take_leaf, grad, s.g_sub),
                lw_sub=lw_sub_new,
                div_sub=s.div_sub | div_leaf,
                turn_sub=s.turn_sub | jnp.any(turning, axis=1),
                q_stk=q_stk, p_stk=p_stk,
            )
            sub_uturn = s.turn_sub

        # --- 3. subtree-boundary bookkeeping -------------------------------
        bd = s.steps_left <= 0
        in_slice = s.log_u <= -h
        div_new = (h - s.h0) > delta_max
        valid = bd & in_slice & ~div_new
        go_right = s.direction > 0

        # store the advanced endpoint on the moving side
        s = s._replace(
            q_l=w(bd & ~go_right, q, s.q_l), p_l=w(bd & ~go_right, p, s.p_l),
            g_l=w(bd & ~go_right, grad, s.g_l),
            q_r=w(bd & go_right, q, s.q_r), p_r=w(bd & go_right, p, s.p_r),
            g_r=w(bd & go_right, grad, s.g_r),
        )

        if multinomial:
            # biased progressive subtree merge (Stan): the finished subtree
            # replaces the trajectory proposal w.p. min(1, W_sub / W_tree);
            # a subtree containing a divergent leaf is discarded entirely
            # (its weight never merges; the trajectory terminates below)
            sub_ok = bd & ~s.div_sub & ~s.turn_sub & jnp.isfinite(s.lw_sub)
            ratio = jnp.exp(jnp.minimum(jnp.asarray(0.0, e_dtype),
                                        s.lw_sub - s.lw_tree))
            take = sub_ok & (swap_u < ratio)
            s = s._replace(
                q_prop=w(take, s.q_sub, s.q_prop),
                lp_prop=jnp.where(take, s.lp_sub, s.lp_prop),
                g_prop=w(take, s.g_sub, s.g_prop),
                lw_tree=jnp.where(sub_ok,
                                  jnp.logaddexp(s.lw_tree, s.lw_sub),
                                  s.lw_tree),
                diverged=s.diverged | (bd & s.div_sub),
            )
        else:
            # endpoint-validity proposal swap (reference NUTS.py:319-336)
            subtree_size = jnp.int32(1) << s.depth
            n_new = jnp.where(valid, subtree_size, 0)
            total = s.n_valid + jnp.where(bd, n_new, 0)
            swap_prob = jnp.where(
                valid & (total > 0),
                n_new.astype(jnp.float32)
                / jnp.maximum(total, 1).astype(jnp.float32),
                0.0)
            take = bd & (swap_u < swap_prob)
            s = s._replace(
                q_prop=w(take, q, s.q_prop),
                lp_prop=jnp.where(take, lp, s.lp_prop),
                g_prop=w(take, grad, s.g_prop),
                n_valid=total,
                diverged=s.diverged | (bd & div_new),
            )

        # termination: reference while cond is evaluated AFTER the doubling —
        # depth+1 >= max ∨ u_turn(tree) ∨ diverged
        dq = s.q_r - s.q_l
        # raw-momentum test for BOTH metrics (reference NUTS.py:191-198):
        # dq.p is d/dt ||dq||^2_M — the M-norm U-turn criterion — and is
        # invariant under whitening, so the dense oracle-metric machine is
        # exactly the identity-metric machine on whitened coordinates. See
        # samplers/nuts.py::_u_turn for the measured ridge-clipping bias of
        # the velocity-space alternative.
        u_turn = ((jnp.sum(dq * s.p_l, axis=-1) < 0)
                  | (jnp.sum(dq * s.p_r, axis=-1) < 0))
        term_cond = (s.depth + 1 >= max_tree_depth) | u_turn | s.diverged
        if multinomial:
            term_cond = term_cond | sub_uturn   # invalid subtree: stop here
        term = bd & term_cond
        cont = bd & ~term

        # transition completes: adopt proposal, log stats, flag fresh start
        mean_alpha = s.sum_alpha / jnp.maximum(s.n_steps, 1).astype(e_dtype)
        mean_alpha = jnp.where(jnp.isfinite(mean_alpha), mean_alpha,
                               jnp.asarray(0.65, e_dtype))
        # snapshot reservoir: the k-th completed transition of this window
        # replaces the reservoir with probability 1/k, so the reservoir is a
        # uniform draw over the window's completions — one embedded-chain
        # state per window, with no occupancy (trajectory-duration) weighting
        k_new = s.k_res + term.astype(jnp.int32)
        take_res = term & (res_u * k_new.astype(jnp.float32) < 1.0)
        s = s._replace(
            q=w(term, s.q_prop, s.q),
            lp=jnp.where(term, s.lp_prop, s.lp),
            grad=w(term, s.g_prop, s.grad),
            transitions=s.transitions + term.astype(jnp.int32),
            divergences=s.divergences + (term & s.diverged).astype(jnp.int32),
            alpha_acc=s.alpha_acc + jnp.where(term, mean_alpha, 0.0),
            depth_acc=s.depth_acc + jnp.where(term, s.depth + 1, 0),
            needs_start=term,
            q_res=w(take_res, s.q_prop, s.q_res),
            lp_res=jnp.where(take_res, s.lp_prop, s.lp_res),
            k_res=k_new,
        )

        # trajectory continues: next doubling from the chosen end
        new_depth = s.depth + 1
        new_dir = jnp.where(dir2_bit, 1.0, -1.0).astype(pos_dtype)
        nxt_right = cont & (new_dir > 0)
        nxt_left = cont & (new_dir <= 0)
        s = s._replace(
            depth=jnp.where(cont, new_depth, s.depth),
            steps_left=jnp.where(cont, jnp.int32(1) << new_depth, s.steps_left),
            direction=jnp.where(cont, new_dir, s.direction),
            q_c=w(nxt_right, s.q_r, w(nxt_left, s.q_l, s.q_c)),
            p_c=w(nxt_right, s.p_r, w(nxt_left, s.p_l, s.p_c)),
            g_c=w(nxt_right, s.g_r, w(nxt_left, s.g_l, s.g_c)),
        )
        if multinomial:
            # fresh subtree: empty weight reservoir (its first leaf always
            # replaces q_sub, so the stale contents are never observable)
            s = s._replace(
                lw_sub=jnp.where(cont, jnp.asarray(-jnp.inf, e_dtype),
                                 s.lw_sub),
                div_sub=jnp.where(cont, False, s.div_sub),
                turn_sub=jnp.where(cont, False, s.turn_sub),
            )
        return s, None

    return step


def _count_dtype(total=0):
    """Dtype for global leapfrog/slot counters: int64 under x64, else
    uint32, else f32 once the STATIC slot total exceeds uint32's range.

    int32 overflows at 2^31 slots — reached at the advertised operating
    point (65,536 chains x 512 snapshots x 64 steps = 2^31); uint32
    extends the exact range to 4.29e9 without requiring x64. Beyond that
    (e.g. 1024 chains x 10k snapshots x 512 steps/snapshot, the round-5
    window-bias probe) the counters go f32: relative error < 1e-7 on the
    rate accounting, with exact per-chain counts still reported.
    """
    if jax.config.jax_enable_x64:
        return jnp.int64
    return jnp.uint32 if total < 2**32 else jnp.float32


@partial(jax.jit, static_argnames=(
    "log_prob_fn", "num_samples", "steps_per_sample", "burn_in_steps",
    "max_tree_depth", "delta_max", "value_and_grad_fn", "collect_chains",
    "snapshot_mode", "proposal_scheme"))
def nuts_run_persistent(
    key,
    log_prob_fn,
    init_position,
    step_size,
    num_samples: int,
    steps_per_sample: int = 64,
    burn_in_steps: int = 0,
    inv_mass_matrix: Optional[Array] = None,
    max_tree_depth: int = 10,
    delta_max=1000.0,
    value_and_grad_fn: Optional[Callable] = None,
    collect_chains: Optional[int] = None,
    snapshot_mode: str = "uniform",
    proposal_scheme: str = "endpoint",
) -> RunResult:
    """Asynchronous NUTS: `num_samples` snapshots, one every
    `steps_per_sample` global leapfrog iterations.

    Gradient accounting is exact: n_gradients = (burn_in_steps +
    num_samples * steps_per_sample) * n_chains. info carries per-chain
    transition counts, mean accept prob, mean terminal depth, and divergence
    stats with the same keys as `nuts_run`.

    snapshot_mode: 'uniform' (default) emits a reservoir-sampled completed
    transition per window — unbiased over the embedded chain, matching the
    reference's per-transition statistics; 'last' emits the last completed
    state (deterministic-time sampling, length-biased by the next
    transition's duration — see the module docstring for the measured
    effect).

    proposal_scheme: 'endpoint' (default, reference parity — measurably
    ~3% underdispersed, BASELINE.md bias audit) or 'multinomial' (per-leaf
    progressive weighting, Stan's scheme — recovers the bias; see
    _make_window_step).
    """
    if proposal_scheme not in ("endpoint", "multinomial"):
        raise ValueError(f"unknown proposal_scheme: {proposal_scheme!r}")
    multinomial = proposal_scheme == "multinomial"
    state0 = init_chain_state(init_position, log_prob_fn, value_and_grad_fn,
                              needs_grad=True)
    C, D = state0.position.shape
    e_dtype = precision.energy_dtype()
    pos_dtype = state0.position.dtype
    if inv_mass_matrix is None:
        inv_mass_matrix = jnp.ones(D, pos_dtype)
    inv_mass = jnp.asarray(inv_mass_matrix, pos_dtype)

    if value_and_grad_fn is not None:
        def vag_batched(q):
            return value_and_grad_fn(q)
    else:
        single = jax.value_and_grad(log_prob_fn)
        vag_batched = jax.vmap(single)

    step = _make_window_step(vag_batched, step_size, inv_mass,
                             max_tree_depth, delta_max, e_dtype,
                             proposal_scheme=proposal_scheme)

    ps = _init_pstate(state0.position, jnp.asarray(state0.log_prob, e_dtype),
                      state0.grad_log_prob, e_dtype,
                      multinomial=multinomial, max_tree_depth=max_tree_depth)

    def draw_window(k, n):
        kp, kd, kd2, ks, ku, kr = random.split(k, 6)
        return (random.normal(kp, (n, C, D), pos_dtype),
                random.bernoulli(kd, 0.5, (n, C)),
                random.bernoulli(kd2, 0.5, (n, C)),
                random.uniform(ks, (n, C)),
                random.uniform(ku, (n, C), dtype=jnp.float32,
                               minval=jnp.finfo(jnp.float32).tiny),
                random.uniform(kr, (n, C)))

    def run_window(k, ps, n):
        xs = draw_window(k, n)
        return lax.scan(step, ps, xs)[0]

    if burn_in_steps > 0:
        key, bk = random.split(key)
        ps = run_window(bk, ps, burn_in_steps)
        ps = ps._replace(transitions=jnp.zeros_like(ps.transitions),
                         divergences=jnp.zeros_like(ps.divergences),
                         alpha_acc=jnp.zeros_like(ps.alpha_acc),
                         depth_acc=jnp.zeros_like(ps.depth_acc),
                         k_res=jnp.zeros_like(ps.k_res))

    n_collect = collect_chains or C
    uniform_snap = snapshot_mode == "uniform"
    if not uniform_snap and snapshot_mode != "last":
        raise ValueError(f"unknown snapshot_mode: {snapshot_mode!r}")

    def emit(ps, k):
        ps = run_window(k, ps, steps_per_sample)
        if uniform_snap:
            got = ps.k_res > 0
            q_out = jnp.where(got[:, None], ps.q_res, ps.q)[:n_collect]
            lp_out = jnp.where(got, ps.lp_res, ps.lp)[:n_collect]
            ps = ps._replace(k_res=jnp.zeros_like(ps.k_res))
            return ps, (q_out, lp_out)
        return ps, (ps.q[:n_collect], ps.lp[:n_collect])

    keys = random.split(key, num_samples)
    ps, (samples, lps) = lax.scan(emit, ps, keys)

    trans = jnp.maximum(ps.transitions, 1)
    mean_accept = ps.alpha_acc / trans.astype(e_dtype)
    total_div = jnp.sum(ps.divergences)
    total_trans = jnp.sum(ps.transitions)
    info = {
        "divergence_count": ps.divergences,
        "total_divergences": total_div,
        "divergence_rate": total_div.astype(jnp.float32)
        / jnp.maximum(total_trans, 1).astype(jnp.float32),
        "transitions": ps.transitions,
        "mean_accept_probs": mean_accept,
        "mean_tree_depth": ps.depth_acc.astype(jnp.float32) / trans,
        # trace-time dtype choice: exact uint32 until 4.29e9 slots, then
        # f32 (see _count_dtype)
        "n_leapfrogs": jnp.asarray(
            (burn_in_steps + num_samples * steps_per_sample) * C,
            _count_dtype((burn_in_steps + num_samples * steps_per_sample)
                         * C)),
        "n_leapfrogs_per_chain": jnp.full(
            (C,), burn_in_steps + num_samples * steps_per_sample,
            jnp.uint32),
        # the XLA machine executes every slot (one leapfrog per iteration)
        "n_leapfrog_slots": jnp.asarray(
            (burn_in_steps + num_samples * steps_per_sample) * C,
            _count_dtype((burn_in_steps + num_samples * steps_per_sample)
                         * C)),
        "final_positions": ps.q,
    }
    final_state = ChainState(
        position=ps.q, log_prob=ps.lp, grad_log_prob=ps.grad,
        accept_count=ps.transitions,
        divergence_count=ps.divergences)
    accept_rate = mean_accept.astype(jnp.float32)
    return RunResult(samples, lps, accept_rate, final_state, info)
