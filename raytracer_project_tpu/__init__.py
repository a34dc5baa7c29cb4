"""raytracer_project_tpu — a JAX-native differentiable Monte Carlo path tracer.

A from-scratch JAX/XLA re-design of the capabilities of the
reference C++20 engine "Zenith" (jarek1992/raytracer_project): progressive
wavefront path tracing, BVH acceleration, four PBR material families with
textures and bump mapping, three environment-lighting modes, volumetric
media, AOV render passes, a differentiable HDR post-process chain, and
pixel-sharded multi-chip scaling over a jax device mesh.
"""

__version__ = "0.1.0"

import os as _os

# Repository checkout root (the parent of this package directory).
CHECKOUT_DIR = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compilation_cache_dir() -> str | None:
    """Where the persistent XLA compilation cache goes.

    None when JAX_COMPILATION_CACHE_DIR is set: JAX then reads that
    directory itself and the program sets none. Otherwise a fixed path
    inside the checkout, so repeated runs from one checkout hit the cache
    (the path is part of the cache key) and nothing outside it is written.
    """
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _os.path.join(CHECKOUT_DIR, ".jax_cache")


def _enable_compilation_cache() -> None:
    cache_dir = compilation_cache_dir()
    if cache_dir is not None:
        import jax

        jax.config.update("jax_compilation_cache_dir", cache_dir)


_enable_compilation_cache()
