"""Latency-tier vs throughput-tier device routing.

The accelerator earns its keep on the batched book/scenario graphs
(``parallel/``). Curve CONSTRUCTION and single-trade engine requests are
tiny scalar-shaped f64 programs whose cost is dominated by compiling one
program per curve topology and by per-dispatch host<->device latency,
while the same programs run in microseconds on the host CPU backend. This
module routes those two tiers:

 - build tier  (curve bootstraps, refit gates, curve jacobians)
 - request tier (per-trade Engine.compute analytics)

Both default to the host CPU backend when one is available alongside the
accelerator; the book-scale functions in ``parallel/`` never use these
contexts and always target the default backend. Override with
``ADRATES_BUILD_DEVICE`` / ``ADRATES_REQUEST_DEVICE`` set to ``default``
(leave on the default backend, e.g. to check calibration on the card —
``chip_smoke.py`` builds the flagship curves and the quickstart on both
tiers) or ``host``. Which tier is faster on a GPU is not measured yet.

The reference has no equivalent tiering — it is single-device by
construction (SURVEY §2 parallelism checklist).
"""

from __future__ import annotations

import os
from contextlib import contextmanager, nullcontext
from functools import lru_cache


@lru_cache(maxsize=1)
def host_device():
    """The first host-CPU device, or None when the CPU backend is
    unavailable or IS the default backend (nothing to route)."""
    import jax

    try:
        cpu = jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        return None
    if jax.default_backend() == "cpu":
        return None
    return cpu


def _tier_device(env_var: str):
    mode = os.environ.get(env_var, "host").lower()
    if mode == "default":
        return None
    return host_device()


def on_build_device():
    """Context manager: curve-construction compute tier."""
    import jax

    dev = _tier_device("ADRATES_BUILD_DEVICE")
    return jax.default_device(dev) if dev is not None else nullcontext()


def on_request_device():
    """Context manager: per-trade engine-request compute tier."""
    import jax

    dev = _tier_device("ADRATES_REQUEST_DEVICE")
    return jax.default_device(dev) if dev is not None else nullcontext()
