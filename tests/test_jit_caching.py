"""Compile-cache behavior: a second compute() on a new same-shape trade
must reuse the cached XLA executable — zero recompiles. The reference's `_curve_cache` intent
(/root/reference/cavour/market/position/engine.py:2362-2412), done right.
"""

import pytest

from adrates_tpu.models import Model
from adrates_tpu.trades.rates import OIS, XccyBasisSwap, YoYInflationSwap
from adrates_tpu.utils import (CollateralType, CurrencyTypes, CurveTypes,
                               Date, DayCountTypes, FrequencyTypes,
                               InterpTypes, RequestTypes, SwapTypes)

pytestmark = pytest.mark.slow  # file-level wall clock > 60 s

VALUE_DT = Date(1, 1, 2024)
REQS = [RequestTypes.VALUE, RequestTypes.DELTA, RequestTypes.GAMMA]


@pytest.fixture(scope="module")
def model():
    m = Model(VALUE_DT)
    m.build_curve("USD_OIS_SOFR", px_list=[5.3, 4.6, 3.88],
                  tenor_list=["1Y", "2Y", "10Y"],
                  fixed_dcc_type=DayCountTypes.ACT_360,
                  float_dc_type=DayCountTypes.ACT_360,
                  interp_type=InterpTypes.FLAT_FWD_RATES)
    m.build_curve("GBP_OIS_SONIA", px_list=[5.0, 4.3, 3.87],
                  tenor_list=["1Y", "2Y", "10Y"],
                  fixed_dcc_type=DayCountTypes.ACT_365F,
                  float_dc_type=DayCountTypes.ACT_365F,
                  interp_type=InterpTypes.FLAT_FWD_RATES)
    m.build_xccy_curve(name="GBP_USD_XCCY",
                       domestic_curve_name="USD_OIS_SOFR",
                       foreign_curve_name="GBP_OIS_SONIA",
                       basis_spreads=[-5.0, -11.0],
                       tenor_list=["2Y", "10Y"], spot_fx=1.27)
    m.build_fx(["GBPUSD"], [1.27])
    m.build_inflation_curve("GBP_RPI_INFLATION",
                            breakeven_list=[3.6, 3.5, 3.4],
                            tenor_list=["2Y", "5Y", "10Y"], base_cpi=293.0)
    return m


def _cache_sizes(curve):
    cache = getattr(curve, "_jit_cache", {})
    return {k: fn._cache_size() for k, fn in cache.items()
            if hasattr(fn, "_cache_size")}


def _assert_no_recompile(curve, make_trade, model, reqs,
                         collateral_type=None):
    t1 = make_trade(0.03)
    t1.position(model).compute(reqs, collateral_type=collateral_type)
    before = _cache_sizes(curve)
    assert before, "expected cached jitted analytics on the curve"

    t2 = make_trade(0.041)  # same shape, different content
    t2.position(model).compute(reqs, collateral_type=collateral_type)
    after = _cache_sizes(curve)
    assert after == before, (
        f"same-shape recompute must not add compiles: {before} -> {after}")
    assert all(v == 1 for v in after.values()), after


class TestNoRecompile:
    def test_xccy_swap(self, model):
        def make(coupon):
            return XccyBasisSwap(
                effective_dt=VALUE_DT, term_dt_or_tenor="2Y",
                domestic_notional=12_700_000, foreign_notional=10_000_000,
                domestic_spread=0.0, foreign_spread=coupon / 100,
                domestic_freq_type=FrequencyTypes.QUARTERLY,
                foreign_freq_type=FrequencyTypes.QUARTERLY,
                domestic_dc_type=DayCountTypes.ACT_360,
                foreign_dc_type=DayCountTypes.ACT_365F,
                domestic_floating_index=CurveTypes.USD_OIS_SOFR,
                foreign_floating_index=CurveTypes.GBP_OIS_SONIA,
                domestic_currency=CurrencyTypes.USD,
                foreign_currency=CurrencyTypes.GBP)
        _assert_no_recompile(model.curves["GBP_USD_XCCY"], make, model,
                             REQS)

    def test_yoy_inflation_swap(self, model):
        index = model.curves["GBP_RPI_INFLATION"] \
            ._used_swaps[0]._inflation_index

        def make(coupon):
            return YoYInflationSwap(VALUE_DT, "5Y", SwapTypes.PAY, coupon,
                                    index, FrequencyTypes.ANNUAL,
                                    notional=1_000_000)
        _assert_no_recompile(model.curves["GBP_RPI_INFLATION"], make,
                             model, REQS)

    def test_ois_under_collateral(self, model):
        def make(coupon):
            return OIS(VALUE_DT, "2Y", SwapTypes.RECEIVE, coupon,
                       FrequencyTypes.ANNUAL, DayCountTypes.ACT_365F,
                       CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
                       notional=10_000_000,
                       float_dc_type=DayCountTypes.ACT_365F)
        _assert_no_recompile(model.curves["GBP_USD_XCCY"], make, model,
                             REQS, collateral_type=CollateralType.USD)

    def test_ois_natural(self, model):
        curve = model.curves.GBP_OIS_SONIA

        def make(coupon):
            return OIS(VALUE_DT, "2Y", SwapTypes.RECEIVE, coupon,
                       FrequencyTypes.ANNUAL, DayCountTypes.ACT_365F,
                       CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
                       notional=10_000_000,
                       float_dc_type=DayCountTypes.ACT_365F)
        _assert_no_recompile(curve, make, model, REQS)
