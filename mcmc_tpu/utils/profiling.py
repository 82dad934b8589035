"""Profiling and throughput counters.

The reference's only tracing is wall-clock prints around warmup/sampling
(reference run_benchmarks.py:497-557, SURVEY.md §5); here that is upgraded to
jax.profiler integration plus steps/sec and ESS/sec counters — the BASELINE
metrics — while keeping simple wall-clock timers for the result schema.
"""

import contextlib
import os
import subprocess
import time
from typing import Dict, Optional

import jax


@contextlib.contextmanager
def wall_timer():
    """Wall-clock timer context: `with wall_timer() as t: ...; t.elapsed`."""
    class _T:
        elapsed = 0.0
    t = _T()
    start = time.time()
    try:
        yield t
    finally:
        t.elapsed = time.time() - start


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """jax.profiler trace context (viewable in TensorBoard / Perfetto).

    No-op when log_dir is None so call sites can be left in production code.
    """
    if log_dir is None:
        yield
        return
    with jax.profiler.trace(log_dir):
        yield


def force_completion(tree):
    """Timing barrier: wait until every array in the pytree is computed."""
    return jax.block_until_ready(tree)


def gpu_name_and_power_limit() -> Optional[str]:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (one line per card), or
    None where nvidia-smi is absent or fails. Every device number is
    reported beside it: a card set below its maximum limit runs slower."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def device_record() -> Dict:
    """The devices JAX reports (platform, kind, count) and the cards'
    name/power limit: the record every measurement is printed with."""
    devices = jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
            "name_power_limit": gpu_name_and_power_limit()}


def throughput_counters(num_samples: int, n_chains: int, num_steps: int,
                        sample_time: float, ess_bulk_min: Optional[float] = None,
                        n_devices: int = 1) -> Dict[str, float]:
    """steps/sec, chain-steps/sec, grad-evals/sec and ESS/sec(/chip)."""
    chain_steps = num_samples * n_chains
    out = {
        "steps_per_sec": num_samples / sample_time,
        "chain_steps_per_sec": chain_steps / sample_time,
        "grad_evals_per_sec": chain_steps * num_steps / sample_time,
        "chain_steps_per_sec_per_chip": chain_steps / sample_time / n_devices,
    }
    if ess_bulk_min is not None:
        out["ess_per_sec"] = ess_bulk_min / sample_time
        out["ess_per_sec_per_chip"] = ess_bulk_min / sample_time / n_devices
    return out


# The checkpoint's own cache directory (listed in .gitignore): a fixed path,
# so a later process of the same checkout finds what an earlier one cached.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compilation_cache(default_dir: str = DEFAULT_CACHE_DIR):
    """Enable the persistent XLA compilation cache unless the user opted out.

    Policy (shared by the CLIs, bench.py and chip_smoke.py): honor
    JAX_COMPILATION_CACHE_DIR if the variable is SET — including
    set-to-empty, which disables caching. Only when unset fall back to
    `default_dir`, the checkout's `.jax_cache`. Safe to call any time
    before the first compilation.
    """
    if "JAX_COMPILATION_CACHE_DIR" in os.environ:
        path = os.environ["JAX_COMPILATION_CACHE_DIR"]
    else:
        path = default_dir
    # empty -> None actively DISABLES a previously-enabled cache, so the
    # opt-out works even after an earlier enable in the same process
    jax.config.update("jax_compilation_cache_dir", path or None)
