"""Single-trajectory tracers and HMC-vs-GRAHMC animations.

Feature parity with the reference's animations/animation.py:101-258: trace one
chain's proposal trajectory at substep resolution — position q, momentum p,
potential U, kinetic K, Hamiltonian H per leapfrog substep — and render a
side-by-side HMC vs GRAHMC animation on a 2D bimodal target.

Difference: the tracer is the same conformal-leapfrog integrator as
the samplers, run with a scan that COLLECTS the per-substep state (a
trajectory dump), instead of a separate Python reimplementation. Animations
are saved as GIF via the Pillow writer (no ffmpeg dependency).
"""

from typing import Dict, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax, random

from mcmc_tpu.samplers.grahmc import get_friction_schedule


def _traced_trajectory(q0, p0, lp0, grad0, value_and_grad, step_size,
                       num_steps, inv_mass, friction_schedule, gamma,
                       steepness):
    """Run one chain's trajectory collecting every substep. q0: (dim,)."""
    eps = jnp.asarray(step_size, q0.dtype)
    half = 0.5 * eps
    total_time = eps * num_steps

    def substep(carry, i):
        q, p, lp, grad = carry
        if friction_schedule is not None:
            # midpoint friction grid — parity with samplers/trajectory.py
            gamma_t = friction_schedule((i.astype(q.dtype) + 0.5) * eps,
                                        total_time, gamma, steepness)
            scale = jnp.exp(-gamma_t * half)
            p = p * scale
        p = p + half * grad
        q = q + eps * (p * inv_mass)
        lp, grad = value_and_grad(q)
        p = p + half * grad
        if friction_schedule is not None:
            p = p * scale
        kinetic = 0.5 * jnp.sum(p * p * inv_mass)
        return (q, p, lp, grad), (q, p, -lp, kinetic)

    (_, _, _, _), (qs, ps, Us, Ks) = lax.scan(
        substep, (q0, p0, lp0, grad0), jnp.arange(num_steps))

    K0 = 0.5 * jnp.sum(p0 * p0 * inv_mass)
    qs = jnp.concatenate([q0[None], qs], axis=0)
    ps = jnp.concatenate([p0[None], ps], axis=0)
    Us = jnp.concatenate([jnp.asarray(-lp0)[None], Us], axis=0)
    Ks = jnp.concatenate([K0[None], Ks], axis=0)
    return qs, ps, Us, Ks


def _proposal_trace(key, log_prob_fn, q0, step_size, num_steps,
                    value_and_grad_fn=None, inv_mass_matrix=None,
                    friction_schedule=None, gamma=1.0, steepness=1.0) -> Dict:
    q0 = jnp.asarray(q0)
    dim = q0.shape[-1]
    # Single-sample (dim,) adapter: analytic vags are shape-polymorphic;
    # black-box log-probs go through jax.value_and_grad.
    vag1 = (value_and_grad_fn if value_and_grad_fn is not None
            else jax.value_and_grad(log_prob_fn))
    if inv_mass_matrix is None:
        inv_mass_matrix = jnp.ones(dim, q0.dtype)

    lp0, grad0 = vag1(q0)
    p0 = random.normal(key, (dim,), dtype=q0.dtype) / jnp.sqrt(inv_mass_matrix)

    qs, ps, Us, Ks = _traced_trajectory(
        q0, p0, lp0, grad0, vag1,
        step_size, num_steps, inv_mass_matrix, friction_schedule,
        jnp.asarray(gamma, q0.dtype), jnp.asarray(steepness, q0.dtype))
    return {
        "positions": np.asarray(qs),
        "momenta": np.asarray(ps),
        "potential": np.asarray(Us),
        "kinetic": np.asarray(Ks),
        "hamiltonian": np.asarray(Us + Ks),
        "num_steps": num_steps,
        "step_size": step_size,
    }


def hmc_proposal_trace(key, log_prob_fn, q0, step_size, num_steps,
                       value_and_grad_fn=None, inv_mass_matrix=None) -> Dict:
    """Per-substep (q, p, U, K, H) for one HMC proposal from q0 (dim,)."""
    return _proposal_trace(key, log_prob_fn, q0, step_size, num_steps,
                           value_and_grad_fn, inv_mass_matrix,
                           friction_schedule=None)


def rahmc_proposal_trace(key, log_prob_fn, q0, step_size, num_steps,
                         gamma=1.0, steepness=1.0, schedule_type="constant",
                         value_and_grad_fn=None, inv_mass_matrix=None) -> Dict:
    """Per-substep (q, p, U, K, H) for one GRAHMC proposal from q0 (dim,)."""
    return _proposal_trace(key, log_prob_fn, q0, step_size, num_steps,
                           value_and_grad_fn, inv_mass_matrix,
                           friction_schedule=get_friction_schedule(schedule_type),
                           gamma=gamma, steepness=steepness)


grahmc_proposal_trace = rahmc_proposal_trace


def animate_sampler_comparison(
    key=None,
    separation: float = 5.0,
    step_size: float = 0.15,
    num_steps: int = 40,
    gamma: float = 1.0,
    n_proposals: int = 12,
    schedule_type: str = "constant",
    output_file: str = "hmc_vs_grahmc.gif",
    fps: int = 12,
) -> str:
    """Side-by-side HMC vs GRAHMC trajectory animation on a 2D bimodal target.

    Renders each sampler's substep path over the target density contours (the
    reference's FuncAnimation layout, animation.py:240-252) and saves a GIF.
    Returns the output path.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    from mcmc_tpu.targets import gaussian_mixture

    if key is None:
        key = random.PRNGKey(0)
    target = gaussian_mixture(dim=2, separation=separation)

    # Collect trajectories: evolve both samplers from the same start.
    traces = {"HMC": [], f"GRAHMC ({schedule_type})": []}
    q_h = jnp.array([-separation / 2.0, 0.0])
    q_g = q_h
    for i in range(n_proposals):
        key, k1, k2 = random.split(key, 3)
        tr_h = hmc_proposal_trace(k1, target.log_prob_fn, q_h, step_size,
                                  num_steps, target.value_and_grad_fn)
        tr_g = rahmc_proposal_trace(k2, target.log_prob_fn, q_g, step_size,
                                    num_steps, gamma=gamma,
                                    schedule_type=schedule_type,
                                    value_and_grad_fn=target.value_and_grad_fn)
        traces["HMC"].append(tr_h)
        traces[f"GRAHMC ({schedule_type})"].append(tr_g)
        q_h = jnp.asarray(tr_h["positions"][-1])
        q_g = jnp.asarray(tr_g["positions"][-1])

    # Density contours
    grid = np.linspace(-separation, separation, 120)
    X, Y = np.meshgrid(grid, grid)
    pts = jnp.asarray(np.stack([X.ravel(), Y.ravel()], axis=-1))
    Z = np.asarray(target.log_prob_fn(pts)).reshape(X.shape)

    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    artists = []
    for ax, name in zip(axes, traces):
        ax.contour(X, Y, np.exp(Z), levels=8, cmap="Greys", alpha=0.6)
        line, = ax.plot([], [], "-", lw=1.2, color="tab:red", alpha=0.8)
        dot, = ax.plot([], [], "o", color="tab:blue", markersize=6)
        ax.set_title(name)
        ax.set_xlim(-separation, separation)
        ax.set_ylim(-separation, separation)
        artists.append((line, dot, name))

    frames_per_prop = num_steps + 1
    total_frames = n_proposals * frames_per_prop

    def update(frame):
        prop_idx = frame // frames_per_prop
        sub_idx = frame % frames_per_prop
        out = []
        for line, dot, name in artists:
            tr = traces[name][prop_idx]
            xs = tr["positions"][: sub_idx + 1, 0]
            ys = tr["positions"][: sub_idx + 1, 1]
            line.set_data(xs, ys)
            dot.set_data(xs[-1:], ys[-1:])
            out.extend([line, dot])
        return out

    anim = FuncAnimation(fig, update, frames=total_frames, blit=True)
    anim.save(output_file, writer=PillowWriter(fps=fps))
    plt.close(fig)
    print(f"  saved {output_file}")
    return output_file
