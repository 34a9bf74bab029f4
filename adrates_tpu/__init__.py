"""adrates_tpu — a fixed-income pricing and AD-risk framework in JAX.

Capabilities mirror ludcode/ADRates ("Cavour"): multi-currency OIS / XCCY /
inflation curve bootstrapping, swaps/bonds/FRNs/inflation products priced as
discounted cashflows, and exact tenor-bucketed deltas, NxN gammas and
cross-gammas via JAX autodiff chained through the curve bootstrap.

Architecture (accelerator-first, not a port):
 - trade *compilation* (dates/calendars/day counts/schedules) happens once in
   Python and produces static padded cashflow tensors;
 - *pricing* is pure jitted JAX (lax.scan bootstraps, fused interpolation,
   jacrev/hessian risk), vmap-able over books and scenario grids and
   shardable over device meshes with shard_map/GSPMD.

Numerical policy: float64 (enabled at import) to hold the reference's
1e-10..1e-12 calibration tolerances.
"""

import jax

jax.config.update("jax_enable_x64", True)

from . import utils
from .utils import *  # noqa: F401,F403 — conventions are the base namespace
from .utils.compile_cache import (configure_cache,  # noqa: F401
                                  export_cache, import_cache)

__version__ = "0.1.0"
