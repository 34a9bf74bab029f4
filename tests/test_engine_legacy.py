"""Legacy raw-input engine API: bootstrap parity, leg analytics, FD checks.

Covers the reference's raw (swap_rates, swap_times, year_fracs) entry
points (reference engine.py:2246-3180): build_curve_ad,
value/valuation/delta/gamma_fixed_leg and value/valuation/delta/gamma_
float_leg. Gradients are validated against central finite differences of
the same value functions, and par consistency is checked by netting a
receiver fixed leg against a payer float leg priced off the bootstrapped
curve.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from adrates_tpu.market.position.engine import Engine
from adrates_tpu.requests.results import Delta, Gamma, Valuation
from adrates_tpu.trades.rates.swap_fixed_leg import SwapFixedLeg
from adrates_tpu.trades.rates.swap_float_leg import SwapFloatLeg
from adrates_tpu.utils import (CalendarTypes, CurrencyTypes, CurveTypes,
                               Date, DayCountTypes, FrequencyTypes,
                               InterpTypes, SwapTypes)

VALUE_DT = Date(1, 1, 2024)
RATES = [0.052, 0.048, 0.0452, 0.0431]
INTERP = InterpTypes.FLAT_FWD_RATES


def _legs(coupon, years, notional=1e6):
    common = dict(freq_type=FrequencyTypes.ANNUAL,
                  dc_type=DayCountTypes.SIMPLE,
                  floating_index=CurveTypes.GBP_OIS_SONIA,
                  currency=CurrencyTypes.GBP,
                  notional=notional,
                  cal_type=CalendarTypes.NONE)
    fixed = SwapFixedLeg(VALUE_DT, f"{years}Y", SwapTypes.RECEIVE, coupon,
                         **common)
    flt = SwapFloatLeg(VALUE_DT, f"{years}Y", SwapTypes.PAY, spread=0.0,
                       **common)
    return fixed, flt


# Curve input swaps (1Y/2Y/3Y/5Y annual) use the LEGS' own accrual
# fractions so curve nodes coincide exactly with leg payment times —
# under SIMPLE daycount both are actual-days/365 sums of contiguous
# accruals, so knot interpolation is exact.
_FR = [float(f) for f in _legs(0.0, 5)[0]._year_fracs]
FRACS = [_FR[:1], _FR[:2], _FR[:3], _FR[:5]]
TIMES = [sum(f) for f in FRACS]


@pytest.fixture(scope="module")
def engine():
    return Engine(model=None)


class TestBuildCurveAd:
    def test_t0_point_and_monotonic_dfs(self, engine):
        times, dfs = engine.build_curve_ad(RATES, TIMES, FRACS)
        assert float(times[0]) == 0.0
        assert float(dfs[0]) == 1.0
        # node count: t=0 plus one node per coupon of every swap
        assert times.shape[0] == 1 + sum(len(f) for f in FRACS)
        assert np.all(np.asarray(dfs) > 0.0)
        assert np.all(np.asarray(dfs) <= 1.0)

    def test_matches_reference_recursion(self, engine):
        """Independent numpy simulation of the reference algorithm
        (engine.py:2281-2360): expand all coupon points with the parent
        swap's rate, sort by exact time, map each point's 2-dp-rounded
        previous time to the FIRST occurrence's running pv01, then run
        df_k = (1 - r*A_prev) / (1 + r*alpha_k) sequentially."""
        times, dfs = engine.build_curve_ad(RATES, TIMES, FRACS)
        pts = []
        for i, (rate, fracs) in enumerate(zip(RATES, FRACS)):
            cum = 0.0
            for j, frac in enumerate(fracs):
                prev = cum
                cum += frac
                pts.append(dict(t=cum, key=round(cum, 2), a=frac, r=rate,
                                prev_key=round(prev, 2) if j > 0 else None))
            assert abs(cum - TIMES[i]) < 1e-12
        pts.sort(key=lambda p: p["t"])
        first = {}
        for idx, p in enumerate(pts):
            first.setdefault(p["key"], idx)
        pv01 = np.zeros(len(pts))
        want_dfs = np.zeros(len(pts))
        for idx, p in enumerate(pts):
            a_prev = (0.0 if p["prev_key"] is None
                      else pv01[first[p["prev_key"]]])
            df = (1.0 - p["r"] * a_prev) / (1.0 + p["r"] * p["a"])
            pv01[idx] = a_prev + p["a"] * df
            want_dfs[idx] = df
        np.testing.assert_allclose(np.asarray(times)[1:],
                                   [p["t"] for p in pts], atol=1e-12)
        np.testing.assert_allclose(np.asarray(dfs)[1:], want_dfs,
                                   atol=1e-12)
        # par identity for each quoted swap at its maturity node: the
        # recursion enforces r*pv01_T + df_T = 1 with the shared-prefix
        # annuity
        for rate, T in zip(RATES, TIMES):
            slots = [i for i, p in enumerate(pts)
                     if abs(p["t"] - T) < 1e-12 and p["r"] == rate]
            m = slots[-1]
            assert abs(rate * pv01[m] + want_dfs[m] - 1.0) < 1e-10


    def test_tiny_first_period_annuity(self, engine):
        """Documented divergence from the reference (_legacy_plan
        docstring): a first accrual fraction that rounds to
        0.00 at 2dp keeps its REAL annuity in the chain here, where the
        reference resolves prev_key 0.0 to a seeded t=0 point with
        pv01=0 and silently drops the first period. Our curve truly
        reprices the input swap; the reference's simulation misprices
        it by ~r*alpha_0."""
        rate, fracs = 0.04, [0.004, 1.0]   # 0.004 -> key 0.00
        times, dfs = engine.build_curve_ad([rate], [sum(fracs)], [fracs])
        t = np.asarray(times)[1:]
        d = np.asarray(dfs)[1:]
        np.testing.assert_allclose(t, np.cumsum(fracs), atol=1e-12)
        # full-chain par repricing: r * sum(alpha_j * df_j) + df_T == 1
        pv = rate * np.sum(np.asarray(fracs) * d) + d[-1]
        assert abs(pv - 1.0) < 1e-12
        # the reference's drop-first-annuity recursion yields a
        # different df at the maturity node (divergence ~r*alpha_0*df_0)
        df_ref = (1.0 - rate * 0.0) / (1.0 + rate * fracs[1])
        assert abs(d[-1] - df_ref) > 1e-5
        pv_ref = rate * np.sum(np.asarray(fracs)
                               * np.array([d[0], df_ref])) + df_ref
        assert abs(pv_ref - 1.0) > 1e-4   # the reference misprices


class TestFixedLeg:
    def test_linearity_sign_and_zero_coupon(self, engine):
        """With principal=0 the fixed-leg PV is linear in the coupon,
        zero at coupon 0, and PAY negates RECEIVE."""
        pv1 = float(engine.value_fixed_leg(RATES, TIMES, FRACS,
                                           _legs(0.03, 2)[0],
                                           VALUE_DT, INTERP))
        pv2 = float(engine.value_fixed_leg(RATES, TIMES, FRACS,
                                           _legs(0.06, 2)[0],
                                           VALUE_DT, INTERP))
        pv0 = float(engine.value_fixed_leg(RATES, TIMES, FRACS,
                                           _legs(0.0, 2)[0],
                                           VALUE_DT, INTERP))
        assert pv0 == 0.0
        assert pv2 == pytest.approx(2.0 * pv1, rel=1e-12)
        assert pv1 > 0.0  # receiver of positive coupons
        payer = SwapFixedLeg(VALUE_DT, "2Y", SwapTypes.PAY, 0.03,
                             freq_type=FrequencyTypes.ANNUAL,
                             dc_type=DayCountTypes.SIMPLE,
                             floating_index=CurveTypes.GBP_OIS_SONIA,
                             currency=CurrencyTypes.GBP, notional=1e6,
                             cal_type=CalendarTypes.NONE)
        pv_pay = float(engine.value_fixed_leg(RATES, TIMES, FRACS, payer,
                                              VALUE_DT, INTERP))
        assert pv_pay == pytest.approx(-pv1, rel=1e-12)

    def test_valuation_wrapper(self, engine):
        fixed, _ = _legs(0.048, 2)
        val = engine.valuation_fixed_leg(RATES, TIMES, FRACS, fixed,
                                         VALUE_DT, INTERP)
        assert isinstance(val, Valuation)
        assert val.amount == pytest.approx(
            float(engine.value_fixed_leg(RATES, TIMES, FRACS, fixed,
                                         VALUE_DT, INTERP)), rel=1e-12)
        assert val.currency == CurrencyTypes.GBP

    def test_delta_fd(self, engine):
        fixed, _ = _legs(0.048, 3)
        delta = engine.delta_fixed_leg(RATES, TIMES, FRACS, fixed,
                                       VALUE_DT, INTERP)
        assert isinstance(delta, Delta)
        eps = 1e-7
        for i in range(len(RATES)):
            up = list(RATES); up[i] += eps
            dn = list(RATES); dn[i] -= eps
            fd = (float(engine.value_fixed_leg(up, TIMES, FRACS, fixed,
                                               VALUE_DT, INTERP))
                  - float(engine.value_fixed_leg(dn, TIMES, FRACS, fixed,
                                                 VALUE_DT, INTERP))) \
                / (2 * eps)
            # ladder is scaled per bp
            assert delta.risk_ladder[i] == pytest.approx(fd * 1e-4,
                                                         abs=2e-4)

    def test_gamma_fd(self, engine):
        fixed, _ = _legs(0.048, 3)
        gamma = engine.gamma_fixed_leg(RATES, TIMES, FRACS, fixed,
                                       VALUE_DT, INTERP)
        assert isinstance(gamma, Gamma)
        assert gamma.risk_ladder.shape == (len(RATES), len(RATES))
        # symmetric
        assert np.allclose(gamma.risk_ladder, gamma.risk_ladder.T,
                           atol=1e-12)
        eps = 2e-5
        for i in range(len(RATES)):
            up = list(RATES); up[i] += eps
            dn = list(RATES); dn[i] -= eps
            d_up = engine.delta_fixed_leg(up, TIMES, FRACS, fixed,
                                          VALUE_DT, INTERP).risk_ladder
            d_dn = engine.delta_fixed_leg(dn, TIMES, FRACS, fixed,
                                          VALUE_DT, INTERP).risk_ladder
            fd_row = (d_up - d_dn) / (2 * eps) * 1e-4  # per bp^2
            assert np.allclose(gamma.risk_ladder[i], fd_row, atol=5e-3)


class TestFloatLeg:
    def test_par_netting(self, engine):
        """Receiver fixed at the 3Y par rate nets the payer float leg:
        the bootstrap makes r*annuity + df_T = 1 and the float leg off
        the same curve is worth 1 - df_T (per unit notional)."""
        fixed, flt = _legs(RATES[2], 3)
        pv_fix = float(engine.value_fixed_leg(RATES, TIMES, FRACS, fixed,
                                              VALUE_DT, INTERP))
        pv_flt = float(engine.value_float_leg(RATES, TIMES, FRACS, flt,
                                              VALUE_DT, INTERP))
        assert abs(pv_fix + pv_flt) < 1e-4  # of 1e6 notional

    def test_valuation_wrapper(self, engine):
        _, flt = _legs(0.0, 2)
        val = engine.valuation_float_leg(RATES, TIMES, FRACS, flt,
                                         VALUE_DT, INTERP)
        assert isinstance(val, Valuation)
        assert val.amount == pytest.approx(
            float(engine.value_float_leg(RATES, TIMES, FRACS, flt,
                                         VALUE_DT, INTERP)), rel=1e-12)

    def test_first_fixing_override(self, engine):
        _, flt = _legs(0.0, 2)
        base = float(engine.value_float_leg(RATES, TIMES, FRACS, flt,
                                            VALUE_DT, INTERP))
        fixed_rate = 0.06
        ovr = float(engine.value_float_leg(RATES, TIMES, FRACS, flt,
                                           VALUE_DT, INTERP,
                                           first_fixing_rate=fixed_rate))
        assert ovr != base
        # payer leg: a HIGHER first fixing makes the leg MORE negative
        assert ovr < base

    def test_separate_index_scheme(self, engine):
        _, flt = _legs(0.0, 3)
        a = float(engine.value_float_leg(RATES, TIMES, FRACS, flt,
                                         VALUE_DT, INTERP,
                                         index_curve_type=INTERP))
        b = float(engine.value_float_leg(
            RATES, TIMES, FRACS, flt, VALUE_DT, INTERP,
            index_curve_type=InterpTypes.LINEAR_ZERO_RATES))
        # same curve nodes, different interp scheme between knots: values
        # agree at knots so the difference is small but the path runs
        assert a == pytest.approx(b, rel=1e-6)

    def test_delta_fd(self, engine):
        _, flt = _legs(0.0, 3)
        delta = engine.delta_float_leg(RATES, TIMES, FRACS, flt,
                                       VALUE_DT, INTERP)
        assert isinstance(delta, Delta)
        eps = 1e-7
        for i in range(len(RATES)):
            up = list(RATES); up[i] += eps
            dn = list(RATES); dn[i] -= eps
            fd = (float(engine.value_float_leg(up, TIMES, FRACS, flt,
                                               VALUE_DT, INTERP))
                  - float(engine.value_float_leg(dn, TIMES, FRACS, flt,
                                                 VALUE_DT, INTERP))) \
                / (2 * eps)
            assert delta.risk_ladder[i] == pytest.approx(fd * 1e-4,
                                                         abs=2e-4)

    def test_gamma_shape_and_symmetry(self, engine):
        _, flt = _legs(0.0, 2)
        gamma = engine.gamma_float_leg(RATES, TIMES, FRACS, flt,
                                       VALUE_DT, INTERP)
        assert isinstance(gamma, Gamma)
        assert gamma.risk_ladder.shape == (len(RATES), len(RATES))
        assert np.allclose(gamma.risk_ladder, gamma.risk_ladder.T,
                           atol=1e-12)


class TestFloatLegXccyDiscount:
    """discount_curve_type may be a prebuilt XccyCurve: discounting rides
    the curve's static grid, greeks flow only through the bootstrapped
    index curve (reference engine.py:2825-2864)."""

    @pytest.fixture(scope="class")
    def xccy(self):
        from adrates_tpu.models import Model
        from adrates_tpu.utils import InterpTypes as IT
        m = Model(VALUE_DT)
        m.build_curve("USD_OIS_SOFR",
                      px_list=[5.33, 5.05, 4.60, 4.00, 3.88],
                      tenor_list=["1M", "1Y", "2Y", "5Y", "10Y"],
                      fixed_dcc_type=DayCountTypes.ACT_360,
                      float_dc_type=DayCountTypes.ACT_360,
                      interp_type=IT.FLAT_FWD_RATES)
        m.build_curve("GBP_OIS_SONIA",
                      px_list=[5.19, 4.71, 4.35, 3.93, 3.87],
                      tenor_list=["1M", "1Y", "2Y", "5Y", "10Y"],
                      fixed_dcc_type=DayCountTypes.ACT_365F,
                      float_dc_type=DayCountTypes.ACT_365F,
                      interp_type=IT.FLAT_FWD_RATES)
        m.build_xccy_curve(name="GBP_USD_BASIS",
                           domestic_curve_name="USD_OIS_SOFR",
                           foreign_curve_name="GBP_OIS_SONIA",
                           basis_spreads=[-2.0, -5.0, -8.0],
                           tenor_list=["1Y", "2Y", "5Y"],
                           spot_fx=1.27)
        return m.curves["GBP_USD_BASIS"]

    def test_value_delta_gamma(self, engine, xccy):
        _, flt = _legs(0.0, 3)
        args = (RATES, TIMES, FRACS, flt, VALUE_DT, xccy)
        pv = float(engine.value_float_leg(*args))
        # discounting on the XCCY grid (lower dfs than the domestic
        # bootstrap) still yields a sane payer-leg PV
        assert np.isfinite(pv) and pv < 0.0
        pv_nat = float(engine.value_float_leg(RATES, TIMES, FRACS, flt,
                                              VALUE_DT, INTERP))
        assert pv != pytest.approx(pv_nat, rel=1e-6)

        delta = engine.delta_float_leg(*args)
        eps = 1e-7
        for i in range(len(RATES)):
            up = list(RATES); up[i] += eps
            dn = list(RATES); dn[i] -= eps
            fd = (float(engine.value_float_leg(up, TIMES, FRACS, flt,
                                               VALUE_DT, xccy))
                  - float(engine.value_float_leg(dn, TIMES, FRACS, flt,
                                                 VALUE_DT, xccy))) \
                / (2 * eps)
            assert delta.risk_ladder[i] == pytest.approx(fd * 1e-4,
                                                         abs=2e-4)

        gamma = engine.gamma_float_leg(*args)
        assert gamma.risk_ladder.shape == (len(RATES), len(RATES))
        assert np.allclose(gamma.risk_ladder, gamma.risk_ladder.T,
                           atol=1e-12)

    def test_valuation_wrapper(self, engine, xccy):
        _, flt = _legs(0.0, 2)
        val = engine.valuation_float_leg(RATES, TIMES, FRACS, flt,
                                         VALUE_DT, xccy)
        assert isinstance(val, Valuation)
        assert val.amount == pytest.approx(
            float(engine.value_float_leg(RATES, TIMES, FRACS, flt,
                                         VALUE_DT, xccy)), rel=1e-12)
