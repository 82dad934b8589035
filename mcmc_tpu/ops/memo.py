"""Target-scoped memoization for fused-kernel factories.

The fused kernel factory (`make_fused_grahmc_step`) is keyed on a target's
`value_and_grad_fn` closure — a fresh object per `get_target()` call.  A module-level
``functools.lru_cache`` therefore never hits across target instances but
DOES hold strong references to up to ``maxsize`` dead targets' closures
(datasets baked in), their compiled Pallas executables, and the
backend/interpret resolution from first call.

This decorator stores the cache as an attribute *on the
value_and_grad_fn closure itself*, so:

- entries live exactly as long as the target that owns them — dropping
  the target frees its kernels and dataset immediately;
- repeat calls on the same live target still hit (the memoization the
  samplers rely on to avoid re-tracing per window/call);
- ``jax.default_backend()`` is part of the key, so an in-process
  backend change (tests flipping JAX_PLATFORMS) rebuilds rather than
  serving a kernel resolved for the wrong backend.
"""

import functools
import inspect

import jax

_CACHE_ATTR = "_mcmc_tpu_kernel_cache"


def memoize_on_target(factory):
    """Memoize a kernel factory on its ``value_and_grad_fn`` argument."""
    sig = inspect.signature(factory)
    if "value_and_grad_fn" not in sig.parameters:
        raise TypeError(f"{factory.__name__} has no value_and_grad_fn param")

    @functools.wraps(factory)
    def wrapper(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        vgf = bound.arguments["value_and_grad_fn"]
        if vgf is None:
            # Let the factory raise its own descriptive TypeError.
            return factory(*args, **kwargs)
        key = (factory.__name__, jax.default_backend()) + tuple(
            (name, bound.arguments[name])
            for name in sig.parameters
            if name != "value_and_grad_fn"
        )
        try:
            cache = getattr(vgf, _CACHE_ATTR)
        except AttributeError:
            cache = {}
            setattr(vgf, _CACHE_ATTR, cache)
        try:
            return cache[key]
        except KeyError:
            result = cache[key] = factory(*args, **kwargs)
            return result

    wrapper.__wrapped__ = factory
    return wrapper
