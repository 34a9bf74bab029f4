"""float64 precision gates (docs/f64_notes.md).

Each gate runs a kernel on the active default device and returns its
worst absolute error against host float64 math; ``GATES`` pairs each with
the bound it must stay under. ``tests/test_f64_precision.py`` runs them on
the CPU and ``chip_smoke.py`` on the GPU. Curve builds route to the
host-CPU tier by default (``utils.device_policy``): set
``ADRATES_BUILD_DEVICE=default`` to run the refit gate on an accelerator.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .ops.bootstrap import bootstrap_ois, prepare_ois_plan
from .ops.interpolation import interp_df
from .trades.rates import OIS, OISCurve
from .utils import (BusDayAdjustTypes, CurrencyTypes, CurveTypes, Date,
                    DayCountTypes, FrequencyTypes, InterpTypes, SwapTypes)

_VALUE_DT = Date(1, 1, 2024)


def vector_shape_error() -> float:
    """Elementwise f64 chain on a >=2-element shape (rule 1)."""
    r = jnp.full(4, 0.0451)
    p = jnp.full(4, 0.48640628073446307)
    out = jax.jit(lambda r, p: (1.0 - r * p) / (1.0 + r))(r, p)
    true = (1.0 - 0.0451 * 0.48640628073446307) / 1.0451
    return abs(float(out[0]) - true)


def bootstrap_refit_error() -> float:
    """Worst normalized par-swap repricing error of a wavefront-bootstrapped
    curve (rule 3; the build itself raises above 1e-10)."""
    tenors = ["1M", "6M", "1Y", "18M", "2Y", "5Y", "10Y", "30Y"]
    rates = [5.19, 5.04, 4.71, 4.51, 4.35, 3.93, 3.87, 3.71]
    swaps = [OIS(_VALUE_DT, ten, SwapTypes.PAY, px / 100,
                 FrequencyTypes.ANNUAL, DayCountTypes.ACT_365F,
                 CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
                 bd_type=BusDayAdjustTypes.MODIFIED_FOLLOWING,
                 float_dc_type=DayCountTypes.ACT_365F)
             for ten, px in zip(tenors, rates)]
    curve = OISCurve(_VALUE_DT, swaps, InterpTypes.LINEAR_ZERO_RATES,
                     check_refit=True)
    return max(abs(s.value(_VALUE_DT, curve, None)) / s._notional
               for s in swaps)


def jitted_bootstrap_error() -> float:
    """df recurrences of the jitted bootstrap against host float64."""
    a1 = 0.4986301369863014
    plan = prepare_ois_plan([0.5, 1.5], [[a1], [a1, 1.0]])
    rates = jnp.array([0.0504, 0.0451])
    _, dfs = jax.jit(lambda r: bootstrap_ois(r, plan))(rates)
    d1 = 1.0 / (1.0 + 0.0504 * a1)
    d2 = (1.0 - 0.0451 * a1 * d1) / 1.0451
    return max(abs(float(dfs[1]) - d1), abs(float(dfs[2]) - d2))


def single_element_interp_error() -> float:
    """(1,)-shaped interpolation query (rule 2)."""
    times = jnp.array([0.0, 1.0, 2.0])
    dfs = jnp.array([1.0, 0.9512294245007141, 0.9048374180359595])
    one = jax.jit(lambda t: interp_df(
        t, times, dfs, InterpTypes.FLAT_FWD_RATES))(jnp.array([1.5]))
    return abs(float(one[0]) - np.exp(-(0.05 * 1.5)))  # flat 5% forwards


GATES = (
    ("vector_shape", vector_shape_error, 1e-14),
    ("bootstrap_refit", bootstrap_refit_error, 1e-10),
    ("jitted_bootstrap", jitted_bootstrap_error, 1e-14),
    ("single_element_interp", single_element_interp_error, 1e-12),
)
