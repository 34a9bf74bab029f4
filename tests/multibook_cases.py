"""Shared model/trade builders for the multibook test files.

`test_multibook.py` exceeded 590 s as a single file,
so its classes are split across test_multibook_core / _pertrade /
_sharded / _collateral; the fixtures live here as plain builders and each
file wraps them in its own module-scoped fixtures.
"""

import numpy as np

from adrates_tpu.models import Model
from adrates_tpu.trades.credit import FRN, Bond
from adrates_tpu.trades.rates import OIS, XccyBasisSwap
from adrates_tpu.utils import (BusDayAdjustTypes, CurrencyTypes, CurveTypes,
                               Date, DayCountTypes, FrequencyTypes,
                               InterpTypes, SwapTypes)

VALUE_DT = Date(1, 1, 2024)


def build_model():
    m = Model(VALUE_DT)
    m.build_curve("USD_OIS_SOFR", px_list=[5.3, 5.0, 4.6, 4.0, 3.88],
                  tenor_list=["6M", "1Y", "2Y", "5Y", "10Y"],
                  fixed_dcc_type=DayCountTypes.ACT_360,
                  float_dc_type=DayCountTypes.ACT_360,
                  interp_type=InterpTypes.FLAT_FWD_RATES)
    m.build_curve("GBP_OIS_SONIA", px_list=[5.0, 4.7, 4.3, 3.9, 3.87],
                  tenor_list=["6M", "1Y", "2Y", "5Y", "10Y"],
                  fixed_dcc_type=DayCountTypes.ACT_365F,
                  float_dc_type=DayCountTypes.ACT_365F,
                  interp_type=InterpTypes.FLAT_FWD_RATES)
    m.build_xccy_curve(name="GBP_USD_XCCY",
                       domestic_curve_name="USD_OIS_SOFR",
                       foreign_curve_name="GBP_OIS_SONIA",
                       basis_spreads=[-5.0, -8.0, -11.0],
                       tenor_list=["1Y", "5Y", "10Y"], spot_fx=1.27)
    m.build_fx(["GBPUSD"], [1.27])
    return m


def trades_for(model):
    gbp_ois = OIS(VALUE_DT, "5Y", SwapTypes.RECEIVE, 0.039,
                  FrequencyTypes.ANNUAL, DayCountTypes.ACT_365F,
                  CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
                  notional=10_000_000,
                  float_dc_type=DayCountTypes.ACT_365F,
                  bd_type=BusDayAdjustTypes.MODIFIED_FOLLOWING)
    usd_ois = OIS(VALUE_DT, "2Y", SwapTypes.PAY, 0.045,
                  FrequencyTypes.QUARTERLY, DayCountTypes.ACT_360,
                  CurveTypes.USD_OIS_SOFR, CurrencyTypes.USD,
                  notional=15_000_000,
                  float_dc_type=DayCountTypes.ACT_360,
                  bd_type=BusDayAdjustTypes.MODIFIED_FOLLOWING)
    xccy = XccyBasisSwap(
        effective_dt=VALUE_DT, term_dt_or_tenor="5Y",
        domestic_notional=12_700_000, foreign_notional=10_000_000,
        domestic_spread=0.0, foreign_spread=-0.0008,
        domestic_freq_type=FrequencyTypes.QUARTERLY,
        foreign_freq_type=FrequencyTypes.QUARTERLY,
        domestic_dc_type=DayCountTypes.ACT_360,
        foreign_dc_type=DayCountTypes.ACT_365F,
        domestic_floating_index=CurveTypes.USD_OIS_SOFR,
        foreign_floating_index=CurveTypes.GBP_OIS_SONIA,
        domestic_currency=CurrencyTypes.USD,
        foreign_currency=CurrencyTypes.GBP)
    frn_plain = FRN(VALUE_DT, "5Y", quoted_margin=0.0015,
                    freq_type=FrequencyTypes.QUARTERLY,
                    dc_type=DayCountTypes.ACT_365F,
                    floating_index=CurveTypes.GBP_OIS_SONIA,
                    currency=CurrencyTypes.GBP, face_value=5_000_000)
    frn_capped = FRN(VALUE_DT, "5Y", quoted_margin=0.0015,
                     freq_type=FrequencyTypes.QUARTERLY,
                     dc_type=DayCountTypes.ACT_365F,
                     floating_index=CurveTypes.GBP_OIS_SONIA,
                     currency=CurrencyTypes.GBP, face_value=5_000_000,
                     cap_rate=0.045, floor_rate=0.02)
    bond = Bond(VALUE_DT, "7Y", coupon=0.04,
                freq_type=FrequencyTypes.SEMI_ANNUAL,
                dc_type=DayCountTypes.ACT_365F,
                currency=CurrencyTypes.GBP, face_value=1_000_000)
    return [gbp_ois, usd_ois, xccy, frn_plain, frn_capped, bond]


def direct_pvs_gbp(model, trades):
    """Direct per-trade valuations converted to GBP."""
    gbp = model.curves.GBP_OIS_SONIA
    usd = model.curves.USD_OIS_SOFR
    xccy = model.curves["GBP_USD_XCCY"]
    usdgbp = 1.0 / 1.27
    out = []
    for t in trades:
        it = t.derivative_type.name
        if it == "OIS_SWAP":
            curve = gbp if t._currency == CurrencyTypes.GBP else usd
            fx = 1.0 if t._currency == CurrencyTypes.GBP else usdgbp
            out.append(t.value(VALUE_DT, curve) * fx)
        elif it == "XCCY_SWAP":
            pv_usd = t.value(VALUE_DT, domestic_discount_curve=usd,
                             foreign_discount_curve=gbp,
                             xccy_discount_curve=xccy, spot_fx=1.27)
            out.append(pv_usd * usdgbp)
        elif it == "FRN":
            out.append(t.value(VALUE_DT, gbp, gbp))
        elif it == "BOND":
            out.append(t.value(VALUE_DT, gbp))
        else:
            raise AssertionError(it)
    return np.array(out)


def build_model_infl():
    m = Model(VALUE_DT)
    m.build_curve("GBP_OIS_SONIA", px_list=[5.0, 4.7, 4.3, 3.9, 3.87],
                  tenor_list=["6M", "1Y", "2Y", "5Y", "10Y"],
                  fixed_dcc_type=DayCountTypes.ACT_365F,
                  float_dc_type=DayCountTypes.ACT_365F,
                  interp_type=InterpTypes.FLAT_FWD_RATES)
    m.build_inflation_curve("GBP_RPI_INFLATION",
                            breakeven_list=[3.8, 3.5, 3.4, 3.5, 3.3],
                            tenor_list=["1Y", "3Y", "5Y", "10Y", "30Y"],
                            base_cpi=293.0)
    return m


def infl_trades_for(model):
    from adrates_tpu.trades.rates import (YoYInflationSwap,
                                          ZeroCouponInflationSwap)
    index = model.curves["GBP_RPI_INFLATION"]._used_swaps[0] \
        ._inflation_index
    zcis = ZeroCouponInflationSwap(
        effective_dt=VALUE_DT, term_dt_or_tenor="5Y",
        fixed_leg_type=SwapTypes.PAY, fixed_rate=0.033,
        inflation_index=index, notional=7_000_000)
    yoy = YoYInflationSwap(
        effective_dt=VALUE_DT, term_dt_or_tenor="4Y",
        fixed_leg_type=SwapTypes.RECEIVE, fixed_rate=0.034,
        inflation_index=index, freq_type=FrequencyTypes.ANNUAL,
        notional=5_000_000, inflation_spread=0.0007)
    ois = OIS(VALUE_DT, "5Y", SwapTypes.RECEIVE, 0.039,
              FrequencyTypes.ANNUAL, DayCountTypes.ACT_365F,
              CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
              notional=10_000_000, float_dc_type=DayCountTypes.ACT_365F,
              bd_type=BusDayAdjustTypes.MODIFIED_FOLLOWING)
    return [zcis, yoy, ois]
