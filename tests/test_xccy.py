"""Cross-currency: curve bootstrap refits, swap valuation, multi-curve risk.

Mirrors the reference's test_xccy_*.py family (19 tests across 7 files):
curve build, refit gate at 1e-10, basis/fix-float/fix-fix valuation,
engine-vs-direct parity, and the jacobian stack.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from adrates_tpu.utils import (BusDayAdjustTypes, CurrencyTypes, CurveTypes,
                               Date, DayCountTypes, FrequencyTypes,
                               InterpTypes, RequestTypes, SwapTypes)
from adrates_tpu.models import Model
from adrates_tpu.trades.rates import (XccyBasisSwap, XccyCurve, XccyFixFix,
                                      XccyFixFloat)

pytestmark = pytest.mark.slow  # file-level wall clock > 60 s

VALUE_DT = Date(1, 1, 2024)
TENORS = ["1M", "6M", "1Y", "2Y", "3Y", "5Y", "7Y", "10Y", "20Y", "30Y"]
USD_RATES = [5.33, 5.30, 5.05, 4.60, 4.25, 4.00, 3.90, 3.88, 3.92, 3.85]
GBP_RATES = [5.19, 5.04, 4.71, 4.35, 4.13, 3.93, 3.87, 3.87, 3.88, 3.71]
BASIS_TENORS = ["1Y", "2Y", "5Y", "10Y", "30Y"]
BASIS_BPS = [-2.0, -5.0, -8.0, -11.0, -13.0]
SPOT_FX = 1.27  # USD per GBP (domestic USD, foreign GBP)


@pytest.fixture(scope="module")
def model():
    m = Model(VALUE_DT)
    m.build_curve("USD_OIS_SOFR", px_list=USD_RATES, tenor_list=TENORS,
                  fixed_dcc_type=DayCountTypes.ACT_360,
                  float_dc_type=DayCountTypes.ACT_360,
                  interp_type=InterpTypes.FLAT_FWD_RATES)
    m.build_curve("GBP_OIS_SONIA", px_list=GBP_RATES, tenor_list=TENORS,
                  fixed_dcc_type=DayCountTypes.ACT_365F,
                  float_dc_type=DayCountTypes.ACT_365F,
                  interp_type=InterpTypes.FLAT_FWD_RATES)
    m.build_xccy_curve(name="GBP_USD_BASIS",
                       domestic_curve_name="USD_OIS_SOFR",
                       foreign_curve_name="GBP_OIS_SONIA",
                       basis_spreads=BASIS_BPS, tenor_list=BASIS_TENORS,
                       spot_fx=SPOT_FX)
    return m


@pytest.fixture(scope="module")
def xccy(model):
    return model.curves["GBP_USD_BASIS"]


def make_basis_swap(tenor, spread_bps=0.0, dom_notional=100e6):
    return XccyBasisSwap(
        VALUE_DT, tenor, dom_notional, dom_notional / SPOT_FX, 0.0,
        spread_bps / 1e4, FrequencyTypes.ANNUAL, FrequencyTypes.ANNUAL,
        DayCountTypes.ACT_360, DayCountTypes.ACT_365F,
        CurveTypes.USD_OIS_SOFR, CurveTypes.GBP_OIS_SONIA,
        CurrencyTypes.USD, CurrencyTypes.GBP)


class TestXccyCurve:
    def test_refit_all_pillars(self, model, xccy):
        """Every calibration basis swap reprices to 1e-10."""
        for swap in xccy._used_swaps:
            v = swap.value(VALUE_DT, model.curves.USD_OIS_SOFR,
                           model.curves.GBP_OIS_SONIA,
                           xccy_discount_curve=xccy, spot_fx=SPOT_FX)
            assert abs(v / swap._domestic_notional) < 1e-10

    def test_dfs_positive_decreasing(self, xccy):
        dfs = np.array(xccy._dfs)
        assert np.all(dfs > 0)
        assert dfs[0] == 1.0
        # long end must decay
        assert dfs[-1] < 0.5

    def test_negative_basis_curve_above_foreign_ois(self, model, xccy):
        """Negative basis: df_xccy ~ df_ois * exp(-basis*t) with basis < 0,
        so foreign-in-domestic DFs sit ABOVE the foreign OIS DFs."""
        d10 = VALUE_DT.add_tenor("10Y")
        assert xccy.df(d10) > float(model.curves.GBP_OIS_SONIA.df(d10))

    def test_jacobian_shapes(self, xccy):
        n_nodes = len(np.array(xccy._dfs))
        n_spreads = len(xccy.basis_spreads)
        n_foreign = len(np.array(xccy._foreign_curve._dfs))
        assert xccy._jac_basis.shape == (n_nodes, n_spreads)
        assert xccy._hess_basis.shape == (n_nodes, n_spreads, n_spreads)
        assert xccy._jac_foreign_curve_dfs.shape == (n_nodes, n_foreign)
        assert xccy._mixed_hess_foreign_basis.shape == (n_nodes, n_spreads,
                                                        n_foreign)

    def test_jac_basis_sign(self, xccy):
        """Wider (more positive) basis lowers foreign-in-domestic DFs:
        d(DF)/d(spread) < 0 at pillar nodes."""
        jac = np.array(xccy._jac_basis)
        # last node vs last spread
        assert jac[-1, -1] < 0

    def test_df_act365_override(self, xccy):
        """df() must ignore the day-count argument (node times are
        ACT/365F)."""
        d = VALUE_DT.add_tenor("5Y")
        assert xccy.df(d) == pytest.approx(
            xccy.df(d, DayCountTypes.ACT_360), abs=0)

    def test_all_interp_schemes_refit(self, model):
        for it in (InterpTypes.FLAT_FWD_RATES, InterpTypes.LINEAR_ZERO_RATES,
                   InterpTypes.LINEAR_FWD_RATES):
            xc = model.build_xccy_curve(
                name="GBP_USD_BASIS_TMP",
                domestic_curve_name="USD_OIS_SOFR",
                foreign_curve_name="GBP_OIS_SONIA",
                basis_spreads=BASIS_BPS, tenor_list=BASIS_TENORS,
                spot_fx=SPOT_FX, interp_type=it)
            for swap in xc._used_swaps:
                v = swap.value(VALUE_DT, model.curves.USD_OIS_SOFR,
                               model.curves.GBP_OIS_SONIA,
                               xccy_discount_curve=xc, spot_fx=SPOT_FX)
                assert abs(v / swap._domestic_notional) < 1e-10, it
        del model._curves_dict["GBP_USD_BASIS_TMP"]

    def test_nonflat_foreign_curve_refits(self):
        """LINEAR_ZERO foreign curve: the bootstrap must use the curve's
        own interpolation (the reference hardcodes log-linear and would
        miss refit here)."""
        m = Model(VALUE_DT)
        m.build_curve("USD_OIS_SOFR", px_list=USD_RATES, tenor_list=TENORS,
                      fixed_dcc_type=DayCountTypes.ACT_360,
                      float_dc_type=DayCountTypes.ACT_360,
                      interp_type=InterpTypes.LINEAR_ZERO_RATES)
        m.build_curve("GBP_OIS_SONIA", px_list=GBP_RATES,
                      tenor_list=TENORS,
                      fixed_dcc_type=DayCountTypes.ACT_365F,
                      float_dc_type=DayCountTypes.ACT_365F,
                      interp_type=InterpTypes.LINEAR_ZERO_RATES)
        xc = m.build_xccy_curve(name="GBP_USD_BASIS",
                                domestic_curve_name="USD_OIS_SOFR",
                                foreign_curve_name="GBP_OIS_SONIA",
                                basis_spreads=BASIS_BPS,
                                tenor_list=BASIS_TENORS, spot_fx=SPOT_FX)
        for swap in xc._used_swaps:
            v = swap.value(VALUE_DT, m.curves.USD_OIS_SOFR,
                           m.curves.GBP_OIS_SONIA,
                           xccy_discount_curve=xc, spot_fx=SPOT_FX)
            assert abs(v / swap._domestic_notional) < 1e-10

    def test_quarterly_legs_refit(self, model):
        from adrates_tpu.models.xccy_builder import build_xccy_curve
        xc = build_xccy_curve(
            model, "GBP_USD_BASIS_Q",
            domestic_curve_name="USD_OIS_SOFR",
            foreign_curve_name="GBP_OIS_SONIA",
            basis_spreads=BASIS_BPS, tenor_list=BASIS_TENORS,
            spot_fx=SPOT_FX,
            domestic_freq_type=FrequencyTypes.QUARTERLY,
            foreign_freq_type=FrequencyTypes.QUARTERLY)
        for swap in xc._used_swaps:
            v = swap.value(VALUE_DT, model.curves.USD_OIS_SOFR,
                           model.curves.GBP_OIS_SONIA,
                           xccy_discount_curve=xc, spot_fx=SPOT_FX)
            assert abs(v / swap._domestic_notional) < 1e-10
        del model._curves_dict["GBP_USD_BASIS_Q"]


class TestBasisSwapValuation:
    def test_pillar_swap_is_par(self, model, xccy):
        swap = make_basis_swap("5Y", spread_bps=-8.0)
        v = swap.value(VALUE_DT, model.curves.USD_OIS_SOFR,
                       model.curves.GBP_OIS_SONIA,
                       xccy_discount_curve=xccy, spot_fx=SPOT_FX)
        assert abs(v / 100e6) < 1e-10

    def test_spread_above_par_gains_for_payer(self, model, xccy):
        """More negative paid spread (we PAY foreign + spread) raises PV."""
        v_less = make_basis_swap("5Y", -10.0).value(
            VALUE_DT, model.curves.USD_OIS_SOFR, model.curves.GBP_OIS_SONIA,
            xccy_discount_curve=xccy, spot_fx=SPOT_FX)
        v_more = make_basis_swap("5Y", -6.0).value(
            VALUE_DT, model.curves.USD_OIS_SOFR, model.curves.GBP_OIS_SONIA,
            xccy_discount_curve=xccy, spot_fx=SPOT_FX)
        assert v_less > v_more

    def test_engine_equals_direct(self, model, xccy):
        swap = make_basis_swap("7Y", -9.0)
        direct = swap.value(VALUE_DT, model.curves.USD_OIS_SOFR,
                            model.curves.GBP_OIS_SONIA,
                            xccy_discount_curve=xccy, spot_fx=SPOT_FX)
        res = swap.position(model).compute([RequestTypes.VALUE])
        assert res.value.amount == pytest.approx(direct, abs=1e-6)
        assert res.value.currency == CurrencyTypes.USD


class TestXccyRisk:
    @pytest.fixture(scope="class")
    def result(self, model):
        swap = make_basis_swap("7Y", -9.0)
        return swap.position(model).compute(
            [RequestTypes.VALUE, RequestTypes.DELTA, RequestTypes.GAMMA])

    def test_three_delta_ladders(self, result):
        assert result.risk(CurveTypes.USD_OIS_SOFR) is not None
        assert result.risk(CurveTypes.GBP_OIS_SONIA) is not None
        assert result.risk(CurveTypes.GBP_USD_BASIS) is not None

    def test_domestic_float_leg_near_zero_delta(self, result):
        """A par-projected domestic float leg w/ exchanges has ~no rate
        delta on its own discounting curve."""
        d = result.risk(CurveTypes.USD_OIS_SOFR)
        assert abs(d.value.amount) < 1.0

    def test_basis_delta_vs_fd(self, model, result):
        """5Y basis bump of 0.1bp: AD vs rebuild-FD within 0.1%."""
        from adrates_tpu.models.xccy_builder import build_xccy_curve
        swap = make_basis_swap("7Y", -9.0)
        params = {k: v for k, v in
                  model._curve_params_dict["GBP_USD_BASIS"].items()
                  if k != "use_ad"}
        base_v = swap.value(VALUE_DT, model.curves.USD_OIS_SOFR,
                            model.curves.GBP_OIS_SONIA,
                            xccy_discount_curve=model.curves[
                                "GBP_USD_BASIS"],
                            spot_fx=SPOT_FX)
        m2 = Model(VALUE_DT)
        m2._curves_dict = dict(model._curves_dict)
        up = dict(params)
        up["basis_spreads"] = list(params["basis_spreads"])
        up["basis_spreads"][2] += 0.1
        xc_up = build_xccy_curve(m2, "TMP", **up)
        v_up = swap.value(VALUE_DT, model.curves.USD_OIS_SOFR,
                          model.curves.GBP_OIS_SONIA,
                          xccy_discount_curve=xc_up, spot_fx=SPOT_FX)
        fd = (v_up - base_v) / 0.1
        ad = float(result.risk(CurveTypes.GBP_USD_BASIS).risk_ladder[2])
        assert abs(ad - fd) / abs(fd) < 1e-3

    def test_foreign_delta_vs_fd_xccy_fixed(self, model, result):
        """Foreign OIS delta holds the XCCY curve fixed (reference policy,
        engine.py:1692-1700): compare against FD that rebuilds only the
        foreign OIS curve."""
        swap = make_basis_swap("7Y", -9.0)
        xccy = model.curves["GBP_USD_BASIS"]
        base_v = swap.value(VALUE_DT, model.curves.USD_OIS_SOFR,
                            model.curves.GBP_OIS_SONIA,
                            xccy_discount_curve=xccy, spot_fx=SPOT_FX)
        up = model.scenario("GBP_OIS_SONIA", 0.01)   # +1bp parallel
        dn = model.scenario("GBP_OIS_SONIA", -0.01)
        v_up = swap.value(VALUE_DT, model.curves.USD_OIS_SOFR,
                          up.curves.GBP_OIS_SONIA,
                          xccy_discount_curve=xccy, spot_fx=SPOT_FX)
        v_dn = swap.value(VALUE_DT, model.curves.USD_OIS_SOFR,
                          dn.curves.GBP_OIS_SONIA,
                          xccy_discount_curve=xccy, spot_fx=SPOT_FX)
        fd = (v_up - v_dn) / 2
        ad = result.risk(CurveTypes.GBP_OIS_SONIA).value.amount
        assert abs(ad - fd) / abs(fd) < 1e-3

    def test_gamma_matrices_symmetric(self, result):
        for ct in (CurveTypes.USD_OIS_SOFR, CurveTypes.GBP_OIS_SONIA,
                   CurveTypes.GBP_USD_BASIS):
            g = result.gamma(ct).risk_ladder
            np.testing.assert_allclose(g, g.T, rtol=1e-8, atol=1e-12)

    def test_cross_gamma_present(self, result):
        cg = result.gamma.cross_gamma(CurveTypes.GBP_OIS_SONIA,
                                      CurveTypes.GBP_USD_BASIS)
        assert cg is not None
        n_for = len(TENORS)
        n_basis = len(BASIS_TENORS)
        assert cg.risk_matrix.shape == (n_for, n_basis)
        assert np.any(cg.risk_matrix != 0.0)


class TestStrictCurveRouting:
    """Mismatched XCCY pairs must raise, never silently discount on some
    other pair's basis curve."""

    def test_missing_ois_curve_raises_libError(self, model):
        from adrates_tpu.utils import LibError
        bad = XccyBasisSwap(
            VALUE_DT, "5Y", 100e6, 100e6 / 1.09, 0.0, -0.001,
            FrequencyTypes.ANNUAL, FrequencyTypes.ANNUAL,
            DayCountTypes.ACT_360, DayCountTypes.ACT_360,
            CurveTypes.USD_OIS_SOFR, CurveTypes.EUR_OIS_ESTR,
            CurrencyTypes.USD, CurrencyTypes.EUR)
        with pytest.raises(LibError, match="EUR_OIS_ESTR"):
            bad.position(model).compute([RequestTypes.VALUE])

    def test_mismatched_pair_raises_naming_the_pair(self):
        """A model holding exactly ONE XccyCurve of the WRONG pair must
        raise (the pre-round-3 fallback silently used it)."""
        from adrates_tpu.utils import LibError
        m = Model(VALUE_DT)
        for name, rates, dc in [
                ("USD_OIS_SOFR", [5.3, 5.0, 4.6], DayCountTypes.ACT_360),
                ("GBP_OIS_SONIA", [5.0, 4.7, 4.3], DayCountTypes.ACT_365F),
                ("EUR_OIS_ESTR", [3.9, 3.6, 3.2], DayCountTypes.ACT_360)]:
            m.build_curve(name, px_list=rates,
                          tenor_list=["1Y", "2Y", "5Y"],
                          fixed_dcc_type=dc, float_dc_type=dc,
                          interp_type=InterpTypes.FLAT_FWD_RATES)
        m.build_xccy_curve(name="GBP_USD_BASIS",
                           domestic_curve_name="USD_OIS_SOFR",
                           foreign_curve_name="GBP_OIS_SONIA",
                           basis_spreads=[-2.0, -5.0],
                           tenor_list=["1Y", "5Y"], spot_fx=SPOT_FX)
        bad = XccyBasisSwap(
            VALUE_DT, "5Y", 100e6, 100e6 / 1.09, 0.0, -0.001,
            FrequencyTypes.ANNUAL, FrequencyTypes.ANNUAL,
            DayCountTypes.ACT_360, DayCountTypes.ACT_360,
            CurveTypes.USD_OIS_SOFR, CurveTypes.EUR_OIS_ESTR,
            CurrencyTypes.USD, CurrencyTypes.EUR)
        with pytest.raises(LibError, match="EUR_OIS_ESTR/USD_OIS_SOFR"):
            bad.position(m).compute([RequestTypes.VALUE])

    def test_explicit_fallback_optin(self, model):
        from adrates_tpu.market.position.engine_xccy import find_xccy_curve
        bad = XccyBasisSwap(
            VALUE_DT, "5Y", 100e6, 100e6 / 1.09, 0.0, -0.001,
            FrequencyTypes.ANNUAL, FrequencyTypes.ANNUAL,
            DayCountTypes.ACT_360, DayCountTypes.ACT_360,
            CurveTypes.USD_OIS_SOFR, CurveTypes.EUR_OIS_ESTR,
            CurrencyTypes.USD, CurrencyTypes.EUR)
        name, curve = find_xccy_curve(model, bad, allow_fallback=True)
        assert name == "GBP_USD_BASIS"

    def test_unknown_basis_label_raises(self):
        from adrates_tpu.market.position.engine_xccy import \
            basis_curve_type
        from adrates_tpu.utils import LibError
        with pytest.raises(LibError, match="CHF_CAD_BASIS"):
            basis_curve_type(CurrencyTypes.CHF, CurrencyTypes.CAD)


class TestFixFloatAndFixFix:
    def test_fix_float_engine_equals_direct(self, model, xccy):
        ff = XccyFixFloat(VALUE_DT, "5Y", 100e6, 100e6 / SPOT_FX,
                          SwapTypes.PAY, 0.04, -0.0008,
                          FrequencyTypes.ANNUAL, FrequencyTypes.ANNUAL,
                          DayCountTypes.ACT_360, DayCountTypes.ACT_365F,
                          CurveTypes.USD_OIS_SOFR, CurveTypes.GBP_OIS_SONIA,
                          CurrencyTypes.USD, CurrencyTypes.GBP)
        direct = ff.value(VALUE_DT, model.curves.USD_OIS_SOFR,
                          model.curves.GBP_OIS_SONIA, xccy, SPOT_FX)
        res = ff.position(model).compute([RequestTypes.VALUE,
                                          RequestTypes.DELTA])
        assert res.value.amount == pytest.approx(direct, abs=1e-6)
        # fixed domestic payer: positive delta to domestic rates
        assert res.risk(CurveTypes.USD_OIS_SOFR).value.amount > 0

    def test_fix_fix_engine_equals_direct(self, model, xccy):
        fx2 = XccyFixFix(VALUE_DT, "5Y", 100e6, 100e6 / SPOT_FX,
                         SwapTypes.PAY, 0.04, 0.038,
                         FrequencyTypes.ANNUAL, FrequencyTypes.ANNUAL,
                         DayCountTypes.ACT_360, DayCountTypes.ACT_365F,
                         CurveTypes.USD_OIS_SOFR, CurveTypes.GBP_OIS_SONIA,
                         CurrencyTypes.USD, CurrencyTypes.GBP)
        direct = fx2.value(VALUE_DT, model.curves.USD_OIS_SOFR,
                           model.curves.GBP_OIS_SONIA, xccy, SPOT_FX)
        res = fx2.position(model).compute([RequestTypes.VALUE])
        assert res.value.amount == pytest.approx(direct, abs=1e-6)

    def test_fix_fix_mirror(self, model, xccy):
        kw = dict(domestic_freq_type=FrequencyTypes.ANNUAL,
                  foreign_freq_type=FrequencyTypes.ANNUAL,
                  domestic_dc_type=DayCountTypes.ACT_360,
                  foreign_dc_type=DayCountTypes.ACT_365F,
                  domestic_floating_index=CurveTypes.USD_OIS_SOFR,
                  foreign_floating_index=CurveTypes.GBP_OIS_SONIA,
                  domestic_currency=CurrencyTypes.USD,
                  foreign_currency=CurrencyTypes.GBP)
        pay = XccyFixFix(VALUE_DT, "5Y", 100e6, 100e6 / SPOT_FX,
                         SwapTypes.PAY, 0.04, 0.038, **kw)
        rec = XccyFixFix(VALUE_DT, "5Y", 100e6, 100e6 / SPOT_FX,
                         SwapTypes.RECEIVE, 0.04, 0.038, **kw)
        args = (VALUE_DT, model.curves.USD_OIS_SOFR,
                model.curves.GBP_OIS_SONIA, xccy, SPOT_FX)
        assert pay.value(*args) == pytest.approx(-rec.value(*args),
                                                 abs=1e-6)


class TestMixedDayCountXccy:
    """Regression: the XCCY bootstrap's coupon model must match value():
    forward DF queries at LEG-basis times and the forward divisor in the
    foreign curve's day count. With ACT_360-calibrated OIS curves and
    ACT_365F basis-swap legs the old plan (assuming the alphas cancel and
    querying at curve-basis times) mis-calibrated by ~2e-3 normalized PV
    and the refit gate fired."""

    def test_quarterly_mixed_dc_refits(self):
        m = Model(VALUE_DT)
        # build_curve defaults: ACT_360 float legs on both curves
        m.build_curve("USD_OIS_SOFR", px_list=USD_RATES, tenor_list=TENORS)
        m.build_curve("GBP_OIS_SONIA", px_list=GBP_RATES, tenor_list=TENORS)
        from adrates_tpu.models.xccy_builder import build_xccy_curve
        xc = build_xccy_curve(
            m, "GBP_USD_BASIS_MIX",
            domestic_curve_name="USD_OIS_SOFR",
            foreign_curve_name="GBP_OIS_SONIA",
            basis_spreads=BASIS_BPS, tenor_list=BASIS_TENORS,
            spot_fx=SPOT_FX,
            domestic_freq_type=FrequencyTypes.QUARTERLY,
            foreign_freq_type=FrequencyTypes.QUARTERLY)
        for swap in xc._used_swaps:
            v = swap.value(VALUE_DT, m.curves.USD_OIS_SOFR,
                           m.curves.GBP_OIS_SONIA,
                           xccy_discount_curve=xc, spot_fx=SPOT_FX)
            assert abs(v / swap._domestic_notional) < 1e-10
