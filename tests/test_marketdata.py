"""Market data layer: FX routing, constants, Bloomberg gating, model FX.

Mirrors the reference's FX routing coverage (market_data_engine.py:282-455)
plus the OIS-under-cross-currency-collateral engine path.
"""

import pytest

from adrates_tpu.utils import (CollateralType, CurrencyTypes, CurveTypes,
                               Date, DayCountTypes, FrequencyTypes,
                               InterpTypes, LibError, RequestTypes,
                               SwapTypes)
from adrates_tpu.marketdata import (FX_MARKET_DATA, MARKET_DATA,
                                    FXRoutingEngine, MarketCurveBuilder)
from adrates_tpu.models import Model
from adrates_tpu.trades.rates import OIS

pytestmark = pytest.mark.slow  # file-level wall clock > 60 s

VALUE_DT = Date(1, 1, 2024)


class TestFXRouting:
    def test_direct_rate(self):
        r = FXRoutingEngine({"GBPUSD": 1.27})
        assert r.rate("GBPUSD") == 1.27

    def test_inverse_rate(self):
        r = FXRoutingEngine({"GBPUSD": 1.27})
        assert r.rate("USDGBP") == pytest.approx(1 / 1.27)

    def test_cross_via_usd(self):
        r = FXRoutingEngine({"GBPUSD": 1.27, "EURUSD": 1.08})
        assert r.get_cross_rate("EUR", "GBP") == pytest.approx(1.08 / 1.27)
        assert r.get_path("EUR", "GBP") == ["EUR", "USD", "GBP"]

    def test_multi_hop(self):
        r = FXRoutingEngine({"EURUSD": 1.08, "USDJPY": 150.0,
                             "GBPUSD": 1.27})
        assert r.get_cross_rate("GBP", "JPY") == pytest.approx(1.27 * 150)

    def test_same_currency(self):
        r = FXRoutingEngine({"GBPUSD": 1.27})
        assert r.get_cross_rate("USD", "USD") == 1.0

    def test_no_route_raises(self):
        r = FXRoutingEngine({"GBPUSD": 1.27})
        with pytest.raises(LibError):
            r.get_cross_rate("EUR", "JPY")

    def test_negative_rate_raises(self):
        r = FXRoutingEngine()
        with pytest.raises(LibError):
            r.set_fx_rate("GBPUSD", -1.0)

    def test_bulk(self):
        r = FXRoutingEngine()
        r.set_bulk_fx_rates({"EURUSD": 1.08, "GBPUSD": 1.27})
        assert r.rate("EURUSD") == 1.08


class TestConstants:
    def test_sonia_strip(self):
        cfg = MARKET_DATA["GBP_OIS_SONIA"]
        assert cfg["tickers"]["1Y"] == "BPSWS1 BGN Curncy"
        assert cfg["tickers"]["18M"] == "BPSWS1F BGN Curncy"
        assert cfg["conventions"]["fixed_day_count"] == \
            DayCountTypes.ACT_365F
        assert len(cfg["tickers"]) == 32

    def test_sofr_strip(self):
        cfg = MARKET_DATA["USD_OIS_SOFR"]
        assert cfg["tickers"]["10Y"] == "USOSFR10 BGNL Curncy"
        assert cfg["conventions"]["payment_lag"] == 2

    def test_xccy_strip(self):
        cfg = MARKET_DATA["GBPUSD_XCCY_SONIA_SOFR"]
        assert cfg["domestic_curve"] == "USD_OIS_SOFR"
        assert cfg["conventions"]["interp_type"] == \
            InterpTypes.FLAT_FWD_RATES

    def test_fx_pairs(self):
        assert FX_MARKET_DATA["GBPUSD"]["ticker"] == "GBPUSD Curncy"


class TestBloombergGating:
    def test_fetch_without_xbbg_raises_cleanly(self):
        builder = MarketCurveBuilder(MARKET_DATA, FX_MARKET_DATA)
        with pytest.raises(LibError, match="xbbg"):
            builder.get_curve_inputs("GBP_OIS_SONIA", VALUE_DT)

    def test_unknown_curve_raises(self):
        builder = MarketCurveBuilder(MARKET_DATA, FX_MARKET_DATA)
        with pytest.raises(KeyError):
            builder.get_curve_inputs("NOPE", VALUE_DT)


class TestModelFX:
    def test_build_fx_and_inverse(self):
        m = Model(VALUE_DT)
        m.build_fx(["GBPUSD"], [1.27])
        assert m.fx("GBPUSD") == 1.27
        assert m.fx("USDGBP") == pytest.approx(1 / 1.27)

    def test_fx_routing_fallback(self):
        m = Model(VALUE_DT)
        m.build_fx(["GBPUSD", "EURUSD"], [1.27, 1.08])
        assert m.fx("EURGBP") == pytest.approx(1.08 / 1.27)

    def test_invalid_pair_raises(self):
        m = Model(VALUE_DT)
        with pytest.raises(ValueError):
            m.build_fx(["XXXUSD"], [1.0])


class TestOISUnderXccyCollateral:
    def test_engine_equals_direct(self):
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

        s = OIS(VALUE_DT, "5Y", SwapTypes.RECEIVE, 0.039,
                FrequencyTypes.ANNUAL, DayCountTypes.ACT_365F,
                CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
                notional=10_000_000,
                float_dc_type=DayCountTypes.ACT_365F)
        res = s.position(m).compute([RequestTypes.VALUE,
                                     RequestTypes.DELTA],
                                    collateral_type=CollateralType.USD)
        assert res.value.currency == CurrencyTypes.USD
        direct = s.value(VALUE_DT, m.curves.GBP_OIS_SONIA,
                         collateral_type=CollateralType.USD,
                         xccy_discount_curve=m.curves["GBP_USD_XCCY"],
                         spot_fx=1 / 1.27)
        assert res.value.amount == pytest.approx(direct, abs=1e-6)
        # The collateral path must report BOTH ladders: OIS rates and
        # basis spreads (the reference returns Risk([delta_ois,
        # delta_xccy]), engine.py:455-490)
        from adrates_tpu.utils.global_types import CurveTypes as CT
        assert res.risk is not None
        d_ois = res.risk(CT.GBP_OIS_SONIA)
        d_basis = res.risk(CT.GBP_USD_BASIS)
        assert d_ois is not None and d_basis is not None
        assert any(abs(x) > 1.0 for x in d_basis.risk_ladder), \
            "basis ladder must show non-zero exposure"

    @staticmethod
    def _build_model(xccy_shift_bp=None):
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
        spreads = [-5.0, -8.0, -11.0]
        if xccy_shift_bp is not None:
            i, h = xccy_shift_bp
            spreads[i] += h
        m.build_xccy_curve(name="GBP_USD_XCCY",
                           domestic_curve_name="USD_OIS_SOFR",
                           foreign_curve_name="GBP_OIS_SONIA",
                           basis_spreads=spreads,
                           tenor_list=["1Y", "5Y", "10Y"], spot_fx=1.27)
        m.build_fx(["GBPUSD"], [1.27])
        return m

    @staticmethod
    def _swap():
        return OIS(VALUE_DT, "5Y", SwapTypes.RECEIVE, 0.039,
                   FrequencyTypes.ANNUAL, DayCountTypes.ACT_365F,
                   CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
                   notional=10_000_000,
                   float_dc_type=DayCountTypes.ACT_365F)

    def test_basis_delta_vs_fd(self):
        """AD basis-spread ladder == central FD of the re-bootstrapped
        XCCY curve."""
        from adrates_tpu.utils.global_types import CurveTypes as CT
        m = self._build_model()
        s = self._swap()
        res = s.position(m).compute([RequestTypes.DELTA],
                                    collateral_type=CollateralType.USD)
        ladder = res.risk(CT.GBP_USD_BASIS).risk_ladder

        h = 0.5  # bp
        for i in [1, 2]:  # 5Y and 10Y pillars carry the 5Y trade's risk
            up = self._build_model(xccy_shift_bp=(i, h))
            dn = self._build_model(xccy_shift_bp=(i, -h))
            pv_up = s.position(up).compute(
                [RequestTypes.VALUE],
                collateral_type=CollateralType.USD).value.amount
            pv_dn = s.position(dn).compute(
                [RequestTypes.VALUE],
                collateral_type=CollateralType.USD).value.amount
            fd = (pv_up - pv_dn) / (2 * h)
            assert ladder[i] == pytest.approx(fd, rel=5e-4, abs=1e-4)

    def test_ois_delta_vs_fd_with_recalibration(self):
        """AD OIS-rate ladder under foreign collateral carries the XCCY
        recalibration chain: it must match central FD where the shocked
        scenario re-bootstraps the dependent XCCY curve (scenario() does)."""
        from adrates_tpu.utils.global_types import CurveTypes as CT
        m = self._build_model()
        s = self._swap()
        res = s.position(m).compute([RequestTypes.DELTA],
                                    collateral_type=CollateralType.USD)
        ladder = res.risk(CT.GBP_OIS_SONIA).risk_ladder

        h_pct = 0.01  # percent units for scenario(); 1 bp
        for tenor, i in [("5Y", 3)]:
            up = m.scenario("GBP_OIS_SONIA", {tenor: h_pct})
            dn = m.scenario("GBP_OIS_SONIA", {tenor: -h_pct})
            pv_up = s.position(up).compute(
                [RequestTypes.VALUE],
                collateral_type=CollateralType.USD).value.amount
            pv_dn = s.position(dn).compute(
                [RequestTypes.VALUE],
                collateral_type=CollateralType.USD).value.amount
            fd = (pv_up - pv_dn) / (2 * h_pct * 100)  # per bp
            assert ladder[i] == pytest.approx(fd, rel=5e-4, abs=1e-2)


class TestModelSerialization:
    def test_roundtrip(self, tmp_path):
        m = Model(VALUE_DT)
        m.build_curve("GBP_OIS_SONIA", px_list=[5.0, 4.3, 3.87],
                      tenor_list=["6M", "2Y", "10Y"],
                      fixed_dcc_type=DayCountTypes.ACT_365F,
                      float_dc_type=DayCountTypes.ACT_365F)
        m.build_fx(["GBPUSD"], [1.27])
        path = str(tmp_path / "model.json")
        m.to_json(path)
        m2 = Model.from_json(path)
        assert m2.value_dt == m.value_dt
        assert m2.fx("GBPUSD") == 1.27
        import numpy as np
        np.testing.assert_allclose(
            np.array(m2.curves.GBP_OIS_SONIA._dfs),
            np.array(m.curves.GBP_OIS_SONIA._dfs), atol=0)

    def test_roundtrip_with_xccy_and_inflation(self):
        m = Model(VALUE_DT)
        m.build_curve("USD_OIS_SOFR", px_list=[5.0, 4.3, 3.88],
                      tenor_list=["6M", "2Y", "10Y"],
                      fixed_dcc_type=DayCountTypes.ACT_360,
                      float_dc_type=DayCountTypes.ACT_360,
                      interp_type=InterpTypes.FLAT_FWD_RATES)
        m.build_curve("GBP_OIS_SONIA", px_list=[4.9, 4.2, 3.8],
                      tenor_list=["6M", "2Y", "10Y"],
                      fixed_dcc_type=DayCountTypes.ACT_365F,
                      float_dc_type=DayCountTypes.ACT_365F,
                      interp_type=InterpTypes.FLAT_FWD_RATES)
        m.build_xccy_curve(name="GBP_USD_XCCY",
                           domestic_curve_name="USD_OIS_SOFR",
                           foreign_curve_name="GBP_OIS_SONIA",
                           basis_spreads=[-5.0, -10.0],
                           tenor_list=["2Y", "10Y"], spot_fx=1.27)
        m.build_inflation_curve("GBP_RPI_INFLATION",
                                breakeven_list=[3.6, 3.4],
                                tenor_list=["2Y", "10Y"], base_cpi=293.0)
        text = m.to_json()
        m2 = Model.from_json(text)
        import numpy as np
        np.testing.assert_allclose(
            np.array(m2.curves["GBP_USD_XCCY"]._dfs),
            np.array(m.curves["GBP_USD_XCCY"]._dfs), atol=0)

    def test_inflation_roundtrip_preserves_index_state(self):
        """Seasonality factors, fixings, calendar and interp type must
        survive the JSON round-trip (they were once dropped, so
        restored YoY/ZCIS valuations differed)."""
        import numpy as np
        from adrates_tpu.utils.global_types import InflationInterpTypes
        m = Model(VALUE_DT)
        m.build_curve("GBP_OIS_SONIA", px_list=[4.9, 4.2, 3.8],
                      tenor_list=["6M", "2Y", "10Y"],
                      fixed_dcc_type=DayCountTypes.ACT_365F,
                      float_dc_type=DayCountTypes.ACT_365F,
                      interp_type=InterpTypes.FLAT_FWD_RATES)
        seas = {m: 1.0 for m in range(1, 13)}
        seas[1], seas[7] = 1.002, 0.998
        fixings = [(Date(1, 10, 2023), 291.0), (Date(1, 11, 2023), 292.1)]
        curve, index = m.build_inflation_curve(
            "GBP_RPI_INFLATION", breakeven_list=[3.6, 3.4],
            tenor_list=["2Y", "10Y"], base_cpi=293.0,
            seasonality_factors=seas, fixings=fixings,
            interp_type=InflationInterpTypes.COMPOUND)
        m2 = Model.from_json(m.to_json())
        c2 = m2.curves["GBP_RPI_INFLATION"]
        np.testing.assert_allclose(np.array(c2._dfs),
                                   np.array(curve._dfs), atol=0)
        assert c2._interp_type_infl == InflationInterpTypes.COMPOUND
        # the rebuilt index must carry fixings + seasonality
        idx2 = c2._used_swaps[0]._inflation_index
        assert idx2._seasonality_factors.get(1) == pytest.approx(1.002)
        assert idx2._get_historical_index(Date(1, 10, 2023)) == \
            pytest.approx(291.0)
        np.testing.assert_allclose(
            np.array(m2.curves["GBP_RPI_INFLATION"]._dfs),
            np.array(m.curves["GBP_RPI_INFLATION"]._dfs), atol=0)


class TestOISUnderXccyCollateralMixedDc:
    """Regression: XccyCurve.df pins ACT/365F for its date->time conversion,
    so the engine's discount-side tensor times must be in that basis. With
    ACT_360-accruing trade legs the old kernel discounted at leg-basis times
    and disagreed with direct valuation by ~120 per 10M notional."""

    def test_engine_equals_direct_act360_legs(self):
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

        s = OIS(VALUE_DT, "5Y", SwapTypes.RECEIVE, 0.039,
                FrequencyTypes.ANNUAL, DayCountTypes.ACT_360,
                CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
                notional=10_000_000, float_dc_type=DayCountTypes.ACT_360)
        res = s.position(m).compute([RequestTypes.VALUE],
                                    collateral_type=CollateralType.USD)
        direct = s.value(VALUE_DT, m.curves.GBP_OIS_SONIA,
                         collateral_type=CollateralType.USD,
                         xccy_discount_curve=m.curves["GBP_USD_XCCY"],
                         spot_fx=1 / 1.27)
        assert res.value.amount == pytest.approx(direct, abs=1e-6)


import numpy as np


class TestScenarioDependentRebuild:
    """scenario() must re-bootstrap XCCY curves that depend on the shocked
    OIS curve (their node DFs are functions of the underlying grids); the
    base model must stay untouched."""

    def test_xccy_rebuilt_on_underlying_shock(self):
        m = Model(VALUE_DT)
        m.build_curve("USD_OIS_SOFR", px_list=[5.3, 5.0, 4.6, 4.0, 3.88],
                      tenor_list=["6M", "1Y", "2Y", "5Y", "10Y"])
        m.build_curve("GBP_OIS_SONIA", px_list=[5.0, 4.7, 4.3, 3.9, 3.87],
                      tenor_list=["6M", "1Y", "2Y", "5Y", "10Y"],
                      fixed_dcc_type=DayCountTypes.ACT_365F,
                      float_dc_type=DayCountTypes.ACT_365F)
        m.build_xccy_curve(name="GBP_USD_XCCY",
                           domestic_curve_name="USD_OIS_SOFR",
                           foreign_curve_name="GBP_OIS_SONIA",
                           basis_spreads=[-5.0, -8.0, -11.0],
                           tenor_list=["1Y", "5Y", "10Y"], spot_fx=1.27)
        base = np.asarray(m.curves["GBP_USD_XCCY"]._dfs)

        # Foreign (GBP) shock moves the solved discount grid; a domestic
        # (USD) shock leaves it invariant because the domestic calibration
        # leg is a par floater (float + exchange projected AND discounted
        # on the same curve telescopes to zero PV) — but the curve object
        # must still be re-bootstrapped for consistency.
        shocked = m.scenario("GBP_OIS_SONIA", 0.10)
        xc = shocked.curves["GBP_USD_XCCY"]
        assert xc is not m.curves["GBP_USD_XCCY"]
        assert np.abs(np.asarray(xc._dfs) - base).max() > 1e-5

        shocked_usd = m.scenario("USD_OIS_SOFR", 0.10)
        xc_usd = shocked_usd.curves["GBP_USD_XCCY"]
        assert xc_usd is not m.curves["GBP_USD_XCCY"]
        assert np.abs(np.asarray(xc_usd._dfs) - base).max() < 1e-12

        assert np.allclose(np.asarray(m.curves["GBP_USD_XCCY"]._dfs), base)
