"""End-to-end tour (the reference's notebooks/intro.ipynb as a script).

Covers: multi-curve build, OIS pricing with full AD risk, scenario P&L
attribution, XCCY multi-curve risk, inflation swaps, bonds/FRNs, and
book-scale batched pricing.

Run from the repo root: python examples/quickstart.py   (CPU or GPU)
(The header below makes the repo importable without installing it.)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

from adrates_tpu.utils import *  # noqa: F401,F403
from adrates_tpu.models import Model
from adrates_tpu.trades.rates import (OIS, XccyBasisSwap,
                                      YoYInflationSwap,
                                      ZeroCouponInflationSwap)
from adrates_tpu.trades.credit import FRN, Bond

value_dt = Date(1, 1, 2024)
model = Model(value_dt)

# ---------------------------------------------------------------- curves
model.build_curve(
    "GBP_OIS_SONIA",
    px_list=[5.19, 5.04, 4.71, 4.51, 4.35, 4.13, 3.93, 3.87, 3.87, 3.89,
             3.88, 3.71, 3.33],
    tenor_list=["1M", "6M", "1Y", "18M", "2Y", "3Y", "5Y", "7Y", "10Y",
                "12Y", "20Y", "30Y", "50Y"],
    fixed_dcc_type=DayCountTypes.ACT_365F,
    float_dc_type=DayCountTypes.ACT_365F)

model.build_curve(
    "USD_OIS_SOFR",
    px_list=[5.33, 5.05, 4.60, 4.25, 4.00, 3.90, 3.88, 3.92, 3.85],
    tenor_list=["6M", "1Y", "2Y", "3Y", "5Y", "7Y", "10Y", "20Y", "30Y"],
    fixed_dcc_type=DayCountTypes.ACT_360,
    float_dc_type=DayCountTypes.ACT_360,
    interp_type=InterpTypes.FLAT_FWD_RATES)

model.build_xccy_curve(
    name="GBP_USD_BASIS", domestic_curve_name="USD_OIS_SOFR",
    foreign_curve_name="GBP_OIS_SONIA",
    basis_spreads=[-2.0, -5.0, -8.0, -11.0, -13.0],
    tenor_list=["1Y", "2Y", "5Y", "10Y", "30Y"], spot_fx=1.27)
model.build_fx(["GBPUSD"], [1.27])

infl_curve, rpi = model.build_inflation_curve(
    "GBP_RPI_INFLATION",
    breakeven_list=[3.8, 3.6, 3.5, 3.4, 3.5, 3.45, 3.3],
    tenor_list=["1Y", "2Y", "3Y", "5Y", "10Y", "20Y", "30Y"],
    base_cpi=293.0)

print("curves:", list(model.curves.keys()))

# ------------------------------------------------------------ OIS + risk
swap = OIS(value_dt, "10Y", SwapTypes.RECEIVE, 0.0387,
           FrequencyTypes.ANNUAL, DayCountTypes.ACT_365F,
           CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
           notional=10_000_000, float_dc_type=DayCountTypes.ACT_365F,
           bd_type=BusDayAdjustTypes.MODIFIED_FOLLOWING)
res = swap.position(model).compute(
    [RequestTypes.VALUE, RequestTypes.DELTA, RequestTypes.GAMMA,
     RequestTypes.CASHFLOWS])
print("\n10Y OIS PV:", res.value)
print(res.risk.ladder.df.head(8))
print("gamma total (per bp^2):", res.gamma.value)
print("cashflow rows:", len(res.cashflows))

# Scenario P&L attribution: +100bp parallel
shocked = model.scenario("GBP_OIS_SONIA", 1.0)
pnl = swap.value(value_dt, shocked.curves.GBP_OIS_SONIA) \
    - swap.value(value_dt, model.curves.GBP_OIS_SONIA)
order1 = float(np.sum(res.risk.risk_ladder)) * 100
order2 = order1 + 0.5 * float(np.sum(res.gamma.risk_ladder)) * 100 ** 2
print(f"\n+100bp P&L: actual {pnl:,.0f}  1st-order {order1:,.0f}  "
      f"1st+2nd {order2:,.0f}")

# ------------------------------------------------------------------ XCCY
basis = XccyBasisSwap(value_dt, "7Y", 100e6, 100e6 / 1.27, 0.0, -0.0009,
                      FrequencyTypes.ANNUAL, FrequencyTypes.ANNUAL,
                      DayCountTypes.ACT_360, DayCountTypes.ACT_365F,
                      CurveTypes.USD_OIS_SOFR, CurveTypes.GBP_OIS_SONIA,
                      CurrencyTypes.USD, CurrencyTypes.GBP)
xres = basis.position(model).compute([RequestTypes.VALUE,
                                      RequestTypes.DELTA])
print("\n7Y XCCY basis swap PV:", xres.value)
print("risk:", xres.risk)

# ------------------------------------------------------------- inflation
zcis = ZeroCouponInflationSwap(value_dt, "5Y", SwapTypes.PAY, 0.034, rpi,
                               notional=10_000_000)
zres = zcis.position(model).compute([RequestTypes.VALUE,
                                     RequestTypes.DELTA])
print("\n5Y ZCIS PV:", zres.value, "| risk:", zres.risk)

yoy = YoYInflationSwap(value_dt, "5Y", SwapTypes.PAY, 0.034, rpi,
                       FrequencyTypes.ANNUAL, notional=10_000_000)
print("5Y YoY breakeven:",
      f"{yoy.breakeven_rate(value_dt, model.curves.GBP_OIS_SONIA, infl_curve) * 100:.3f}%")

# ---------------------------------------------------------------- credit
bond = Bond(value_dt, "10Y", 0.04, FrequencyTypes.SEMI_ANNUAL,
            DayCountTypes.THIRTY_E_360, CurrencyTypes.GBP)
gbp = model.curves.GBP_OIS_SONIA
px = bond.clean_price(value_dt, gbp)
print(f"\n10Y 4% bond: clean {px:.4f}  "
      f"ytm {bond.yield_to_maturity(value_dt, px) * 100:.3f}%  "
      f"duration {bond.duration(value_dt, gbp):.2f}")

frn = FRN(value_dt, "5Y", 0.005, FrequencyTypes.QUARTERLY,
          DayCountTypes.ACT_365F, CurrencyTypes.GBP,
          CurveTypes.GBP_OIS_SONIA)
print(f"5Y FRN +50bp: clean {frn.clean_price(value_dt, gbp, gbp):.4f}")

# ------------------------------------------------------------ book scale
import jax.numpy as jnp

from adrates_tpu.parallel import (aggregate_book, compile_book,
                                  make_book_fn, tile_book)

rng = np.random.default_rng(0)
base = [OIS(value_dt, ten, SwapTypes.PAY if i % 2 else SwapTypes.RECEIVE,
            float(rng.uniform(0.02, 0.05)), FrequencyTypes.ANNUAL,
            DayCountTypes.ACT_365F, CurveTypes.GBP_OIS_SONIA,
            CurrencyTypes.GBP, notional=1e6,
            float_dc_type=DayCountTypes.ACT_365F,
            bd_type=BusDayAdjustTypes.MODIFIED_FOLLOWING)
        for i, ten in enumerate(["2Y", "5Y", "10Y", "30Y"] * 5)]
book = tile_book(compile_book(base, value_dt), 50)   # 1000 trades
agg = aggregate_book(book)
fn = make_book_fn(gbp._plan, gbp._interp_type)
shocks = jnp.asarray(rng.normal(0, 1e-3, (10, len(gbp.swap_rates))))
out = fn(jnp.asarray(gbp.swap_rates), book, agg, shocks)
print(f"\nbook: {book.num_trades} trades x 10 scenarios -> "
      f"pvs {out['pvs'].shape}, delta {out['delta'].shape}, "
      f"gamma {out['gamma'].shape}")
print("done.")
