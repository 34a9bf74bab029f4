"""Test configuration: run on CPU with a virtual 8-device mesh so that
multi-device sharding paths are exercised without accelerators, and
enable x64 before JAX initializes. The checks on the GPU itself live in
chip_smoke.py."""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
if os.environ.get("ADRATES_DEBUG_NANS"):
    # CI tracer-hygiene mode (SURVEY §5): fail fast on any NaN produced
    # inside jitted computations.
    jax.config.update("jax_debug_nans", True)

import pytest

from adrates_tpu.utils import (Date, DayCountTypes, FrequencyTypes,
                               BusDayAdjustTypes, CalendarTypes,
                               DateGenRuleTypes, InterpTypes, SwapTypes,
                               CurrencyTypes, CurveTypes)


@pytest.fixture(scope="session")
def value_dt():
    return Date(1, 1, 2024)


@pytest.fixture(scope="session")
def gbp_conventions():
    """GBP SONIA OIS conventions (reference README quick-start)."""
    return dict(
        spot_days=0,
        swap_type=SwapTypes.PAY,
        fixed_dcc_type=DayCountTypes.ACT_365F,
        fixed_freq_type=FrequencyTypes.ANNUAL,
        float_freq_type=FrequencyTypes.ANNUAL,
        float_dc_type=DayCountTypes.ACT_365F,
        bus_day_type=BusDayAdjustTypes.MODIFIED_FOLLOWING,
        interp_type=InterpTypes.LINEAR_ZERO_RATES,
    )


@pytest.fixture(scope="session")
def sonia_quotes():
    """32-pillar GBP SONIA market snapshot (synthetic but realistic)."""
    tenors = ["1M", "2M", "3M", "4M", "5M", "6M", "7M", "8M", "9M", "10M",
              "11M", "1Y", "18M", "2Y", "3Y", "4Y", "5Y", "6Y", "7Y", "8Y",
              "9Y", "10Y", "12Y", "15Y", "20Y", "25Y", "30Y", "35Y", "40Y",
              "45Y", "50Y", "60Y"]
    rates = [5.19, 5.17, 5.15, 5.12, 5.09, 5.04, 4.98, 4.92, 4.87, 4.81,
             4.76, 4.71, 4.51, 4.35, 4.13, 4.00, 3.93, 3.89, 3.87, 3.86,
             3.86, 3.87, 3.89, 3.91, 3.88, 3.80, 3.71, 3.61, 3.51, 3.42,
             3.33, 3.21]
    return tenors, rates


@pytest.fixture(scope="session")
def tol():
    return 1e-10
