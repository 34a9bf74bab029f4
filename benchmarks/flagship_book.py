"""The flagship book: 12 curves and a ~100k-trade mixed book, from a seed.

The end-of-day book-risk run that bench.py and chip_smoke.py drive:

- ``build_model()``: 12 curves across 7 currencies (7 OIS + 3 XCCY + 2
  inflation; 184 quotes);
- ``build_base_trades(model, rng)``: ~1,004 distinct base trade
  topologies (OIS, FRNs incl. capped, XCCY basis / fix-float / fix-fix,
  bonds incl. amortizing, ZCIS and YoY inflation swaps, OIS under USD
  collateral);
- ``build_book(model, seed, n_trades)``: those bases compiled once and
  tiled lazily to ``n_trades`` with a random notional scale per copy.

Everything random comes from ``numpy.random.default_rng(seed)``.
"""

import numpy as np


MAIN_TENORS = ["1M", "2M", "3M", "4M", "5M", "6M", "7M", "8M", "9M", "10M",
               "11M", "1Y", "18M", "2Y", "3Y", "4Y", "5Y", "6Y", "7Y", "8Y",
               "9Y", "10Y", "12Y", "15Y", "20Y", "25Y", "30Y", "35Y", "40Y",
               "45Y", "50Y", "60Y"]
MAIN_RATES = [5.19, 5.17, 5.15, 5.12, 5.09, 5.04, 4.98, 4.92, 4.87, 4.81,
              4.76, 4.71, 4.51, 4.35, 4.13, 4.00, 3.93, 3.89, 3.87, 3.86,
              3.86, 3.87, 3.89, 3.91, 3.88, 3.80, 3.71, 3.61, 3.51, 3.42,
              3.33, 3.21]
SMALL_TENORS = ["3M", "6M", "1Y", "2Y", "3Y", "5Y", "7Y", "10Y", "15Y",
                "20Y", "30Y", "40Y"]
XCCY_TENORS = ["1Y", "2Y", "3Y", "5Y", "7Y", "10Y", "20Y", "30Y"]


def build_model():
    from adrates_tpu.utils import (Date, DayCountTypes,
                                   InflationIndexTypes, InterpTypes)
    from adrates_tpu.models import Model

    value_dt = Date(1, 1, 2024)
    m = Model(value_dt)

    def shifted(rates, d):
        return [r + d for r in rates]

    small = [MAIN_RATES[MAIN_TENORS.index(t)] for t in SMALL_TENORS]

    def ois(name, px, tenors, dc):
        return lambda: m.build_curve(
            name, px_list=px, tenor_list=tenors, fixed_dcc_type=dc,
            float_dc_type=dc, interp_type=InterpTypes.FLAT_FWD_RATES)

    wave1 = [
        ois("GBP_OIS_SONIA", MAIN_RATES, MAIN_TENORS,
            DayCountTypes.ACT_365F),
        ois("USD_OIS_SOFR", shifted(MAIN_RATES, 0.35), MAIN_TENORS,
            DayCountTypes.ACT_360),
        ois("EUR_OIS_ESTR", shifted(MAIN_RATES, -1.2), MAIN_TENORS,
            DayCountTypes.ACT_360),
    ] + [ois(name, shifted(small, d), SMALL_TENORS, dc)
         for name, d, dc in
         [("JPY_OIS_TONAR", -3.2, DayCountTypes.ACT_365F),
          ("CHF_OIS_SARON", -2.5, DayCountTypes.ACT_360),
          ("AUD_OIS_AONIA", 0.1, DayCountTypes.ACT_365F),
          ("CAD_OIS_CORRA", 0.6, DayCountTypes.ACT_365F)]]

    m.build_fx(["GBPUSD", "EURUSD", "JPYUSD", "CHFUSD", "AUDUSD",
                "CADUSD"],
               [1.27, 1.09, 0.0069, 1.13, 0.66, 0.74])

    def xccy(name, dom, forn, fx, spr):
        return lambda: m.build_xccy_curve(
            name=name, domestic_curve_name=dom, foreign_curve_name=forn,
            basis_spreads=[spr + 0.5 * i
                           for i in range(len(XCCY_TENORS))],
            tenor_list=XCCY_TENORS, spot_fx=fx)

    def infl(name, base_cpi, bes, **kw):
        tl = ["1Y", "2Y", "3Y", "5Y", "7Y", "10Y", "20Y", "30Y"]
        return lambda: m.build_inflation_curve(
            name, base_cpi=base_cpi, breakeven_list=bes,
            tenor_list=tl, **kw)

    # inflation (BASELINE config 4 folded into the flagship): breakevens
    # join the packed quote vector, so the NxN gamma spans rates + basis
    # + inflation. Two waves (XCCY needs its parent OIS curves built):
    # distinct curve topologies' first compiles overlap on the thread
    # pool instead of serializing (Model.build_parallel,
    # test_build_parallel.py parity).
    wave2 = [
        xccy("GBP_USD_XCCY", "USD_OIS_SOFR", "GBP_OIS_SONIA", 1.27,
             -8.0),
        xccy("EUR_USD_XCCY", "USD_OIS_SOFR", "EUR_OIS_ESTR", 1.09,
             -18.0),
        xccy("JPY_USD_XCCY", "USD_OIS_SOFR", "JPY_OIS_TONAR", 0.0069,
             -40.0),
        infl("GBP_RPI_INFLATION", 293.0,
             [3.9, 3.75, 3.6, 3.5, 3.45, 3.5, 3.45, 3.35]),
        infl("USD_CPI_INFLATION", 308.0,
             [2.6, 2.45, 2.4, 2.35, 2.35, 2.4, 2.45, 2.4],
             index_type=InflationIndexTypes.US_CPI_U),
    ]
    m.build_parallel(wave1, wave2)
    return m


def build_base_trades(model, rng):
    """~1,000 DISTINCT base trade topologies, so that the book has the
    payment-time diversity of a real one: start dates spread across 4
    years with day-of-month jitter, mixed day counts, frequencies 1/2/4,
    pay lags 0/1/2, EOM and MF/FOLLOWING adjusts, PAY/RECEIVE, capped
    FRNs, amortizing bonds, cross-currency basis + fix-float + fix-fix
    swaps, inflation, and OIS under FOREIGN collateral (discounted on the
    in-graph recalibrating XCCY curves). ``rng`` is a numpy Generator.

    Returns (trades, collateral_types) — entries of the latter are None
    for natural collateral."""
    from adrates_tpu.utils import (BusDayAdjustTypes, CollateralType,
                                   CurrencyTypes, CurveTypes, Date,
                                   DayCountTypes, FrequencyTypes,
                                   SwapTypes)
    from adrates_tpu.trades.credit import FRN, Bond
    from adrates_tpu.trades.rates import (OIS, XccyBasisSwap, XccyFixFix,
                                          XccyFixFloat)

    value_dt = model.value_dt
    trades = []

    ois_defs = [  # (index, ccy, fixed dc, float dc)
        (CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
         DayCountTypes.ACT_365F, DayCountTypes.ACT_365F),
        (CurveTypes.USD_OIS_SOFR, CurrencyTypes.USD,
         DayCountTypes.ACT_360, DayCountTypes.ACT_360),
        (CurveTypes.EUR_OIS_ESTR, CurrencyTypes.EUR,
         DayCountTypes.THIRTY_E_360, DayCountTypes.ACT_360),
        (CurveTypes.JPY_OIS_TONAR, CurrencyTypes.JPY,
         DayCountTypes.ACT_365F, DayCountTypes.ACT_365F),
        (CurveTypes.AUD_OIS_AONIA, CurrencyTypes.AUD,
         DayCountTypes.ACT_365F, DayCountTypes.ACT_365F),
        (CurveTypes.CAD_OIS_CORRA, CurrencyTypes.CAD,
         DayCountTypes.ACT_365F, DayCountTypes.ACT_365F),
    ]
    tenors = ["1Y", "2Y", "3Y", "5Y", "7Y", "10Y", "15Y", "20Y", "30Y",
              "50Y"]
    freqs = [FrequencyTypes.ANNUAL, FrequencyTypes.SEMI_ANNUAL,
             FrequencyTypes.QUARTERLY]
    bds = [BusDayAdjustTypes.MODIFIED_FOLLOWING,
           BusDayAdjustTypes.FOLLOWING]
    # 48 distinct start dates across ~4 years with day-of-month jitter:
    # every variant lands its schedule on different dates, so unique
    # payment-time count grows with diversity instead of collapsing
    # onto the value date's day-of-month
    month_offsets = [-40, -33, -27, -22, -18, -14, -11, -8, -6, -4,
                     -2, 0, 2, 5, 9, 14]
    starts = [value_dt.add_months(m).add_days(int(d))
              for m in month_offsets for d in (0, 7, 17)]

    i = 0
    for idx, ccy, fdc, ldc in ois_defs:
        for ten in tenors:
            for k in range(12):  # 720 OIS, all topology-distinct
                start = starts[(i * 7 + k) % len(starts)]
                trades.append(OIS(
                    start, ten,
                    SwapTypes.PAY if i % 2 else SwapTypes.RECEIVE,
                    float(rng.uniform(0.01, 0.06)),
                    freqs[i % len(freqs)], fdc, idx, ccy,
                    notional=float(rng.uniform(1e6, 2e7)),
                    float_dc_type=ldc,
                    payment_lag=i % 3,
                    bd_type=bds[k % 2]))
                i += 1

    frn_defs = [(CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
                 DayCountTypes.ACT_365F),
                (CurveTypes.USD_OIS_SOFR, CurrencyTypes.USD,
                 DayCountTypes.ACT_360)]
    frn_starts = [value_dt, value_dt.add_months(1).add_days(11),
                  value_dt.add_months(4).add_days(3)]
    for idx, ccy, dc in frn_defs:
        for j, ten in enumerate(["2Y", "3Y", "5Y", "7Y", "10Y", "15Y"]):
            for v in range(5):  # 60 FRNs, 24 capped
                capped = v % 2 == 1
                kwargs = dict(cap_rate=0.055, floor_rate=0.015) \
                    if capped else {}
                trades.append(FRN(
                    frn_starts[v % 3], ten,
                    quoted_margin=float(rng.uniform(0.0005, 0.004)),
                    freq_type=freqs[(j + v) % len(freqs)], dc_type=dc,
                    floating_index=idx, currency=ccy,
                    face_value=float(rng.uniform(1e6, 1e7)), **kwargs))

    xccy_starts = [value_dt, value_dt.add_months(3).add_days(5),
                   value_dt.add_months(9).add_days(13),
                   value_dt.add_months(18)]
    for dom, forn, dom_ccy, for_ccy, fx in [
            (CurveTypes.USD_OIS_SOFR, CurveTypes.GBP_OIS_SONIA,
             CurrencyTypes.USD, CurrencyTypes.GBP, 1.27),
            (CurveTypes.USD_OIS_SOFR, CurveTypes.EUR_OIS_ESTR,
             CurrencyTypes.USD, CurrencyTypes.EUR, 1.09),
            (CurveTypes.USD_OIS_SOFR, CurveTypes.JPY_OIS_TONAR,
             CurrencyTypes.USD, CurrencyTypes.JPY, 0.0069)]:
        for ten in ["2Y", "5Y", "10Y", "20Y", "30Y"]:
            for s in range(4):  # 60 XCCY basis
                dn = float(rng.uniform(5e6, 5e7))
                trades.append(XccyBasisSwap(
                    effective_dt=xccy_starts[s], term_dt_or_tenor=ten,
                    domestic_notional=dn, foreign_notional=dn / fx,
                    domestic_spread=0.0,
                    foreign_spread=float(rng.uniform(-0.002, 0.0)),
                    domestic_freq_type=freqs[2 - s % 2],
                    foreign_freq_type=FrequencyTypes.QUARTERLY,
                    domestic_dc_type=DayCountTypes.ACT_360,
                    foreign_dc_type=DayCountTypes.ACT_365F,
                    domestic_floating_index=dom,
                    foreign_floating_index=forn,
                    domestic_currency=dom_ccy,
                    foreign_currency=for_ccy))

    bond_starts = [value_dt, value_dt.add_months(-31).add_days(9),
                   value_dt.add_months(-9).add_days(21),
                   value_dt.add_months(2)]
    for ccy, dc in [(CurrencyTypes.GBP, DayCountTypes.ACT_365F),
                    (CurrencyTypes.USD, DayCountTypes.THIRTY_360_BOND),
                    (CurrencyTypes.EUR, DayCountTypes.ACT_360)]:
        for j, ten in enumerate(["2Y", "5Y", "7Y", "10Y", "30Y"]):
            for v in range(4):  # 60 bonds, 15 amortizing
                fv = float(rng.uniform(1e6, 1e7))
                freq = (FrequencyTypes.SEMI_ANNUAL if (j + v) % 2
                        else FrequencyTypes.ANNUAL)
                kwargs = {}
                if v == 3:
                    # equal-principal amortizer over coupon periods
                    n_per = int(ten[:-1]) * (
                        2 if freq == FrequencyTypes.SEMI_ANNUAL else 1)
                    kwargs["amortization_schedule"] = \
                        [fv / n_per] * n_per
                trades.append(Bond(
                    bond_starts[v], ten,
                    coupon=float(rng.uniform(0.01, 0.06)),
                    freq_type=freq,
                    dc_type=dc, currency=ccy, face_value=fv, **kwargs))

    # inflation: ZCIS + YoY on both indices (BASELINE config 4)
    from adrates_tpu.trades.rates import (YoYInflationSwap,
                                          ZeroCouponInflationSwap)
    infl_tenors = ["13M", "2Y", "3Y", "4Y", "5Y", "6Y", "7Y", "8Y",
                   "10Y", "12Y", "15Y", "20Y", "30Y"]
    for infl_name in ["GBP_RPI_INFLATION", "USD_CPI_INFLATION"]:
        index = model.curves[infl_name]._used_swaps[0]._inflation_index
        for j, ten in enumerate(infl_tenors):  # 52 inflation
            trades.append(ZeroCouponInflationSwap(
                effective_dt=value_dt, term_dt_or_tenor=ten,
                fixed_leg_type=SwapTypes.PAY if j % 2 else
                SwapTypes.RECEIVE,
                fixed_rate=float(rng.uniform(0.02, 0.04)),
                inflation_index=index,
                notional=float(rng.uniform(1e6, 1e7))))
            trades.append(YoYInflationSwap(
                effective_dt=value_dt, term_dt_or_tenor=ten,
                fixed_leg_type=SwapTypes.RECEIVE if j % 2 else
                SwapTypes.PAY,
                fixed_rate=float(rng.uniform(0.02, 0.04)),
                inflation_index=index,
                freq_type=FrequencyTypes.ANNUAL,
                notional=float(rng.uniform(1e6, 1e7)),
                inflation_spread=float(rng.uniform(-0.001, 0.001))))

    collateral_types = [None] * len(trades)

    # fixed-leg XCCY: fix-float and fix-fix on the calibrated pairs
    # (the fixed-row + manual-exchange path, multibook.py
    # _rows_for_instrument XCCY fixed branches)
    for dom, forn, dom_ccy, for_ccy, fx in [
            (CurveTypes.USD_OIS_SOFR, CurveTypes.GBP_OIS_SONIA,
             CurrencyTypes.USD, CurrencyTypes.GBP, 1.27),
            (CurveTypes.USD_OIS_SOFR, CurveTypes.EUR_OIS_ESTR,
             CurrencyTypes.USD, CurrencyTypes.EUR, 1.09)]:
        for j, ten in enumerate(["2Y", "5Y", "10Y", "20Y", "30Y"]):
            for s in range(2):  # 20 fix-float
                dn = float(rng.uniform(5e6, 3e7))
                trades.append(XccyFixFloat(
                    effective_dt=xccy_starts[s], term_dt_or_tenor=ten,
                    domestic_notional=dn, foreign_notional=dn / fx,
                    domestic_leg_type=SwapTypes.PAY if j % 2 else
                    SwapTypes.RECEIVE,
                    domestic_coupon=float(rng.uniform(0.02, 0.05)),
                    foreign_spread=float(rng.uniform(-0.002, 0.0)),
                    domestic_freq_type=FrequencyTypes.SEMI_ANNUAL,
                    foreign_freq_type=FrequencyTypes.QUARTERLY,
                    domestic_dc_type=DayCountTypes.ACT_360,
                    foreign_dc_type=DayCountTypes.ACT_365F,
                    domestic_floating_index=dom,
                    foreign_floating_index=forn,
                    domestic_currency=dom_ccy,
                    foreign_currency=for_ccy))
                collateral_types.append(None)
        for ten in ["5Y", "10Y", "30Y"]:
            for s in range(2):  # 12 fix-fix
                dn = float(rng.uniform(5e6, 3e7))
                trades.append(XccyFixFix(
                    effective_dt=xccy_starts[s + 1],
                    term_dt_or_tenor=ten,
                    domestic_notional=dn, foreign_notional=dn / fx,
                    domestic_leg_type=SwapTypes.RECEIVE,
                    domestic_coupon=float(rng.uniform(0.02, 0.05)),
                    foreign_coupon=float(rng.uniform(0.02, 0.05)),
                    domestic_freq_type=FrequencyTypes.ANNUAL,
                    foreign_freq_type=FrequencyTypes.ANNUAL,
                    domestic_dc_type=DayCountTypes.ACT_360,
                    foreign_dc_type=DayCountTypes.ACT_365F,
                    domestic_floating_index=dom,
                    foreign_floating_index=forn,
                    domestic_currency=dom_ccy,
                    foreign_currency=for_ccy))
                collateral_types.append(None)

    # OIS under FOREIGN collateral: GBP and EUR swaps discounted on
    # their {CCY}_USD_XCCY curves in-graph (reference
    # engine.py:217-503)
    for idx, ccy, dc in [
            (CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
             DayCountTypes.ACT_365F),
            (CurveTypes.EUR_OIS_ESTR, CurrencyTypes.EUR,
             DayCountTypes.ACT_360)]:
        for j, ten in enumerate(["2Y", "3Y", "5Y", "7Y", "10Y", "12Y",
                                 "15Y", "20Y", "25Y", "30Y"]):
            trades.append(OIS(  # 20 collateralized
                starts[(j * 5) % len(starts)], ten,
                SwapTypes.PAY if j % 2 else SwapTypes.RECEIVE,
                float(rng.uniform(0.01, 0.06)),
                FrequencyTypes.ANNUAL, dc, idx, ccy,
                notional=float(rng.uniform(1e6, 2e7)), float_dc_type=dc,
                bd_type=BusDayAdjustTypes.MODIFIED_FOLLOWING))
            collateral_types.append(CollateralType.USD)

    return trades, collateral_types


def build_book(model, seed: int = 7, n_trades: int = 100_000):
    """Compile the base trades once and tile them lazily to at least
    ``n_trades`` (whole copies), each copy's notionals scaled by a draw
    from U(0.5, 2). Coarse stage buckets merge the 32-pillar majors and
    12-pillar minors into one batched OIS stage.

    Returns (mb_base, mb, scale): the untiled base book, the tiled book
    and the per-copy notional scales."""
    from adrates_tpu.parallel import compile_multibook, tile_multibook
    from adrates_tpu.utils import CurrencyTypes

    rng = np.random.default_rng(seed)
    trades, coll = build_base_trades(model, rng)
    mb_base = compile_multibook(trades, model,
                                base_currency=CurrencyTypes.USD,
                                n_buckets=4, collateral_types=coll,
                                stage_buckets="coarse")
    n_copies = -(-n_trades // len(trades))
    scale = rng.uniform(0.5, 2.0, n_copies)
    return mb_base, tile_multibook(mb_base, n_copies,
                                   notional_scale=scale), scale


def scenario_shocks(n_quotes: int, n_scen: int, seed: int = 7):
    """[n_scen, n_quotes] quote shocks ~ N(0, 10bp); scenario 0 is the
    unshocked base, so its delta is the book's delta at today's quotes."""
    rng = np.random.default_rng([seed, 1])
    shocks = rng.normal(0.0, 1e-3, (n_scen, n_quotes))
    shocks[0] = 0.0
    return shocks
