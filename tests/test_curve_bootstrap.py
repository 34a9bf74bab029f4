"""Curve bootstrap: par repricing gates, DF sanity, scenario rebuilds.

Mirrors the reference's test_curve_bootstrap_validation.py (14 tests) and
test_par_swap_repricing.py / test_refit_curves.py (the core 1e-10 contract).
"""

import numpy as np
import pytest

from adrates_tpu.utils import (BusDayAdjustTypes, CalendarTypes,
                               CurrencyTypes, CurveTypes, Date,
                               DayCountTypes, FrequencyTypes, InterpTypes,
                               LibError, SwapTypes)
from adrates_tpu.models import Model
from adrates_tpu.trades.rates import OIS, OISCurve


pytestmark = pytest.mark.slow  # file-level wall clock > 60 s

def make_swaps(value_dt, tenors, rates, freq=FrequencyTypes.ANNUAL):
    return [OIS(value_dt, ten, SwapTypes.PAY, px / 100, freq,
                DayCountTypes.ACT_365F, CurveTypes.GBP_OIS_SONIA,
                CurrencyTypes.GBP,
                bd_type=BusDayAdjustTypes.MODIFIED_FOLLOWING,
                float_freq_type=freq,
                float_dc_type=DayCountTypes.ACT_365F)
            for ten, px in zip(tenors, rates)]


@pytest.fixture(scope="module")
def full_curve(sonia_quotes):
    value_dt = Date(1, 1, 2024)
    tenors, rates = sonia_quotes
    swaps = make_swaps(value_dt, tenors, rates)
    return value_dt, swaps, OISCurve(value_dt, swaps,
                                     InterpTypes.LINEAR_ZERO_RATES,
                                     check_refit=True)


class TestParRepricing:
    def test_all_inputs_reprice_1e10(self, full_curve):
        value_dt, swaps, curve = full_curve
        for swap in swaps:
            v = swap.value(value_dt, curve, None) / swap._notional
            assert abs(v) < 1e-10, swap._maturity_dt

    @pytest.mark.parametrize("interp", [InterpTypes.FLAT_FWD_RATES,
                                        InterpTypes.LINEAR_ZERO_RATES,
                                        InterpTypes.LINEAR_FWD_RATES,
                                        InterpTypes.PCHIP_LOG_DISCOUNT,
                                        InterpTypes.PCHIP_ZERO_RATES,
                                        InterpTypes.NATCUBIC_LOG_DISCOUNT,
                                        InterpTypes.NATCUBIC_ZERO_RATES,
                                        InterpTypes.FINCUBIC_ZERO_RATES])
    def test_repricing_all_interp_schemes(self, interp, sonia_quotes):
        """Bootstrap solves DFs at coupon points; with the exact-knot
        guard every scheme must reprice its inputs to 1e-10."""
        value_dt = Date(1, 1, 2024)
        tenors = ["1M", "6M", "1Y", "2Y", "5Y", "10Y", "20Y", "30Y"]
        rates = [5.19, 5.04, 4.71, 4.35, 3.93, 3.87, 3.88, 3.71]
        swaps = make_swaps(value_dt, tenors, rates)
        curve = OISCurve(value_dt, swaps, interp, check_refit=True)
        for swap in swaps:
            v = swap.value(value_dt, curve, None) / swap._notional
            assert abs(v) < 1e-10

    def test_quarterly_fixed_legs(self):
        value_dt = Date(15, 6, 2023)
        tenors = ["3M", "6M", "1Y", "2Y", "5Y"]
        rates = [5.3, 5.2, 5.0, 4.6, 4.2]
        swaps = make_swaps(value_dt, tenors, rates,
                           freq=FrequencyTypes.QUARTERLY)
        curve = OISCurve(value_dt, swaps, InterpTypes.FLAT_FWD_RATES,
                         check_refit=True)
        for swap in swaps:
            assert abs(swap.value(value_dt, curve, None)
                       / swap._notional) < 1e-10

    def test_off_pillar_recursion_12y(self, sonia_quotes):
        """12Y after a 10Y pillar exercises the sub-pillar interpolation
        path (the reference hits an IndexError on some combos —
        test_par_swap_repricing.py:17-19; ours must not)."""
        value_dt = Date(1, 1, 2024)
        tenors = ["1Y", "2Y", "5Y", "10Y", "12Y", "20Y"]
        rates = [4.71, 4.35, 3.93, 3.87, 3.89, 3.88]
        swaps = make_swaps(value_dt, tenors, rates)
        curve = OISCurve(value_dt, swaps, InterpTypes.LINEAR_ZERO_RATES,
                         check_refit=True)
        for swap in swaps:
            assert abs(swap.value(value_dt, curve, None)
                       / swap._notional) < 1e-10

    def test_sparse_long_end(self):
        """Long gaps (30Y->50Y) force deep intermediate-point chains."""
        value_dt = Date(1, 1, 2024)
        tenors = ["1Y", "5Y", "30Y", "50Y"]
        rates = [4.71, 3.93, 3.71, 3.33]
        swaps = make_swaps(value_dt, tenors, rates)
        curve = OISCurve(value_dt, swaps, InterpTypes.LINEAR_ZERO_RATES,
                         check_refit=True)
        for swap in swaps:
            assert abs(swap.value(value_dt, curve, None)
                       / swap._notional) < 1e-10


class TestCurveShape:
    def test_dfs_monotone_decreasing(self, full_curve):
        _, _, curve = full_curve
        dfs = np.array(curve._dfs)
        assert np.all(np.diff(dfs) < 0)

    def test_dfs_in_unit_interval(self, full_curve):
        _, _, curve = full_curve
        dfs = np.array(curve._dfs)
        assert np.all(dfs > 0) and np.all(dfs <= 1.0)

    def test_forwards_positive(self, full_curve):
        _, _, curve = full_curve
        times = np.array(curve._times)
        fwds = curve._fwd(np.linspace(0.05, 45.0, 100))
        assert np.all(np.asarray(fwds) > 0)

    def test_anchor(self, full_curve):
        _, _, curve = full_curve
        assert float(curve._times[0]) == 0.0
        assert float(curve._dfs[0]) == 1.0

    def test_zero_rates_sane(self, full_curve):
        value_dt, _, curve = full_curve
        r = curve.zero_rate(value_dt.add_tenor("5Y"))
        assert 0.02 < r < 0.06


class TestCurveQueries:
    def test_df_at_value_date_is_one(self, full_curve):
        value_dt, _, curve = full_curve
        assert curve.df(value_dt) == pytest.approx(1.0, abs=1e-14)

    def test_fwd_rate_vs_dfs(self, full_curve):
        value_dt, _, curve = full_curve
        d1 = value_dt.add_tenor("2Y")
        d2 = value_dt.add_tenor("3Y")
        fr = curve.fwd_rate(d1, d2, DayCountTypes.ACT_360)
        from adrates_tpu.utils import DayCount
        alpha = DayCount(DayCountTypes.ACT_360).year_frac(d1, d2)[0]
        expected = (curve.df(d1) / curve.df(d2) - 1.0) / alpha
        assert fr == pytest.approx(expected, rel=1e-12)

    def test_bump_shifts_forwards(self, full_curve):
        value_dt, _, curve = full_curve
        bumped = curve.bump(0.0001)
        t5 = value_dt.add_tenor("5Y")
        r0 = curve.zero_rate(t5, dc_type=DayCountTypes.ACT_365F)
        r1 = bumped.zero_rate(t5, dc_type=DayCountTypes.ACT_365F)
        assert r1 - r0 == pytest.approx(1e-4, rel=1e-2)

    def test_swap_rate_close_to_quote(self, full_curve):
        value_dt, swaps, curve = full_curve
        # par rate backed out of the curve should match the 10Y quote
        par = curve.swap_rate(value_dt, value_dt.add_tenor("10Y"),
                              FrequencyTypes.ANNUAL,
                              DayCountTypes.ACT_365F)
        assert par == pytest.approx(0.0387, abs=2e-4)


class TestModelScenario:
    def test_parallel_scenario(self, sonia_quotes, gbp_conventions):
        tenors, rates = sonia_quotes
        model = Model(Date(1, 1, 2024))
        model.build_curve("GBP_OIS_SONIA", px_list=rates,
                          tenor_list=tenors, **gbp_conventions)
        shocked = model.scenario("GBP_OIS_SONIA", 0.10)  # +10bp
        r0 = model.curves.GBP_OIS_SONIA.zero_rate(
            Date(1, 1, 2024).add_tenor("5Y"))
        r1 = shocked.curves.GBP_OIS_SONIA.zero_rate(
            Date(1, 1, 2024).add_tenor("5Y"))
        assert r1 > r0
        # par-rate shift != zero-rate shift exactly (compounding/day-count)
        assert r1 - r0 == pytest.approx(0.001, rel=0.10)

    def test_tenor_scenario_only_moves_bucket(self, sonia_quotes,
                                              gbp_conventions):
        tenors, rates = sonia_quotes
        model = Model(Date(1, 1, 2024))
        model.build_curve("GBP_OIS_SONIA", px_list=rates,
                          tenor_list=tenors, **gbp_conventions)
        shocked = model.scenario("GBP_OIS_SONIA", {"10Y": 0.10})
        c0 = model.curves.GBP_OIS_SONIA
        c1 = shocked.curves.GBP_OIS_SONIA
        d1 = Date(1, 1, 2024).add_tenor("1Y")
        assert c1.df(d1) == pytest.approx(c0.df(d1), abs=1e-12)

    def test_unknown_tenor_shock_raises(self, sonia_quotes,
                                        gbp_conventions):
        tenors, rates = sonia_quotes
        model = Model(Date(1, 1, 2024))
        model.build_curve("GBP_OIS_SONIA", px_list=rates,
                          tenor_list=tenors, **gbp_conventions)
        with pytest.raises(LibError):
            model.scenario("GBP_OIS_SONIA", {"99Y": 1.0})

    def test_scenario_grid_batched(self, sonia_quotes, gbp_conventions):
        tenors, rates = sonia_quotes
        model = Model(Date(1, 1, 2024))
        model.build_curve("GBP_OIS_SONIA", px_list=rates,
                          tenor_list=tenors, **gbp_conventions)
        shocks = np.zeros((3, len(tenors)))
        shocks[1, :] = 0.10
        shocks[2, :] = -0.10
        grids = np.array(model.scenario_grid("GBP_OIS_SONIA", shocks))
        assert grids.shape[0] == 3
        base = np.array(model.curves.GBP_OIS_SONIA._dfs)
        np.testing.assert_allclose(grids[0], base, atol=1e-14)
        assert np.all(grids[1][1:] < base[1:])
        assert np.all(grids[2][1:] > base[1:])


class TestValidation:
    def test_unsorted_swaps_raise(self):
        value_dt = Date(1, 1, 2024)
        swaps = make_swaps(value_dt, ["5Y", "2Y"], [3.9, 4.3])
        with pytest.raises(LibError):
            OISCurve(value_dt, swaps, InterpTypes.LINEAR_ZERO_RATES)


class TestNegativeRateShocks:
    """Scenario shocks are applied to the quote vector INSIDE the jitted
    graph, so a low-rate curve can cross zero at runtime even when every
    build-time quote is positive. The bootstrap's log-linear sub-pillar
    interpolation must degrade to linear-space interpolation in-graph
    instead of NaN-ing the whole risk pass (the reference NaNs here —
    ois_curve.py:168-173 logs the shocked rate unconditionally)."""

    def test_shock_across_zero_stays_finite(self):
        import jax
        import jax.numpy as jnp

        from adrates_tpu.ops.bootstrap import bootstrap_ois

        value_dt = Date(1, 1, 2024)
        # JPY-style short end: 30bp 1Y — a 50bp shock goes negative
        swaps = make_swaps(value_dt, ["1Y", "2Y", "5Y", "10Y"],
                           [0.30, 0.45, 0.80, 1.10],
                           freq=FrequencyTypes.SEMI_ANNUAL)
        curve = OISCurve(value_dt, swaps, InterpTypes.FLAT_FWD_RATES,
                         check_refit=True)
        rates = jnp.asarray(curve.swap_rates)
        assert bool(jnp.all(rates > 0))

        shocked = rates - 0.005          # 1Y pillar now negative
        ts, ds = jax.jit(bootstrap_ois)(shocked, curve._plan)
        assert np.all(np.isfinite(np.asarray(ds)))

        # gradients through the shocked region stay finite too
        g = jax.grad(lambda r: jnp.sum(bootstrap_ois(r, curve._plan)[1]))(
            shocked)
        assert np.all(np.isfinite(np.asarray(g)))

        # SECOND order is the sharp edge: linearizing log(max(r, c))
        # materializes -1/safe^2, which overflowed to -Inf at c=1e-300
        # and NaN'd the gamma pass (Inf * zero-tangent). The clamp floor
        # must keep every AD order finite.
        H = jax.hessian(
            lambda r: jnp.sum(bootstrap_ois(r, curve._plan)[1]))(shocked)
        assert np.all(np.isfinite(np.asarray(H)))

    def test_positive_rates_unchanged_by_guard(self):
        import jax
        import jax.numpy as jnp

        from adrates_tpu.ops.bootstrap import bootstrap_ois

        value_dt = Date(1, 1, 2024)
        swaps = make_swaps(value_dt, ["1Y", "3Y", "7Y"], [4.0, 3.8, 3.7],
                           freq=FrequencyTypes.QUARTERLY)
        curve = OISCurve(value_dt, swaps, InterpTypes.FLAT_FWD_RATES,
                         check_refit=True)
        ts, ds = jax.jit(bootstrap_ois)(jnp.asarray(curve.swap_rates),
                                        curve._plan)
        np.testing.assert_allclose(np.asarray(ds),
                                   np.asarray(curve._dfs), rtol=1e-13)
