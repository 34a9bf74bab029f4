"""Persistent XLA compile cache and the host-side jit used by curve builds.

The flagship book-risk programs are the largest compiles in the package.
Nothing about that cost is per-process: XLA's persistent compilation
cache replays the executable, so a second process with the same programs
skips the compiles. A cache directory that moves is never hit, so it
lives at one fixed place:

- ``JAX_COMPILATION_CACHE_DIR``, exactly, where that is set;
- otherwise ``<checkout>/.jax_cache`` (listed in ``.gitignore``).

Usage:
    import adrates_tpu
    adrates_tpu.configure_cache()
    fn = adrates_tpu.parallel.warmup_multibook(mb, n_scenarios=100)
"""

from __future__ import annotations

import os

_CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The one cache directory: JAX_COMPILATION_CACHE_DIR if set, else
    ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _CHECKOUT_CACHE


# Curve-construction kernels run in MICROSECONDS on tiny host-CPU
# shapes, so LLVM codegen quality is irrelevant — but LLVM's optimizer
# dominates their cold compile cost (measured on XLA:CPU: opt level 0
# halves the compile of a representative kernel, 1.38 s -> 0.69 s,
# bitwise identical results — no fast-math is implied by the opt level).
# Scenario and book-scale programs keep full optimization.
BUILD_COMPILER_OPTIONS = {"xla_backend_optimization_level": 0}


def build_jit(fun=None, **jit_kwargs):
    """``jax.jit`` for host-side curve-construction kernels: applies
    :data:`BUILD_COMPILER_OPTIONS`."""
    import jax

    def wrap(f):
        return jax.jit(f, compiler_options=BUILD_COMPILER_OPTIONS,
                       **jit_kwargs)

    return wrap if fun is None else wrap(fun)


def configure_cache(min_compile_secs: float = 1.0) -> str:
    """Enable JAX's persistent compilation cache at :func:`cache_dir` for
    every program this process compiles. Returns the directory. Safe to
    call more than once."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return path


def export_cache(dest_tar: str) -> str:
    """Pack the cache directory into a ``.tar.gz`` to ship with a
    deployment: a host with the same jax version and device kind that
    unpacks it (:func:`import_cache`) skips every compile the build host
    already made."""
    import tarfile

    root = cache_dir()
    if not os.path.isdir(root):
        raise FileNotFoundError(f"no compile cache at {root}")
    with tarfile.open(dest_tar, "w:gz") as tf:
        tf.add(root, arcname=".")
    return dest_tar


def import_cache(src_tar: str, min_compile_secs: float = 1.0) -> str:
    """Unpack an :func:`export_cache` archive into the cache directory
    and activate it. Returns the directory."""
    import tarfile

    root = cache_dir()
    os.makedirs(root, exist_ok=True)
    with tarfile.open(src_tar) as tf:
        tf.extractall(root, filter="data")
    return configure_cache(min_compile_secs=min_compile_secs)
