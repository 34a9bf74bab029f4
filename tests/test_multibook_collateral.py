"""Collateralized books at scale: OIS under FOREIGN collateral inside
compile_multibook.

The book path (multibook._rows_for_instrument collateral branch,
multibook.py) projects a GBP OIS on GBP_OIS_SONIA but discounts on the
GBP_USD_XCCY curve — the reference semantics of
/root/reference/cavour/market/position/engine.py:217-503. Proofs here:

- PV == engine._compute_ois_xccy_collateral (via Position.compute with a
  collateral_type) to 1e-9 relative;
- delta vs the per-trade engine ladder (OIS rates AND basis spreads,
  both THROUGH the in-graph XCCY recalibration) to 1e-8;
- the domestic-curve (USD) delta — which the engine view holds constant
  but the full-recalibration book view carries — against central FD;
- gamma block symmetry + engine parity (own blocks and the rate x basis
  cross block) + an FD check of a diagonal element;
- per-trade ladder/gamma machinery consistency on a mixed
  natural + collateralized book.
"""

import numpy as np
import pytest

from adrates_tpu.parallel import (compile_multibook, make_multibook_fn,
                                  make_per_trade_delta_fn,
                                  make_per_trade_gamma_fn)
from adrates_tpu.utils import (BusDayAdjustTypes, CollateralType,
                               CurrencyTypes, CurveTypes, DayCountTypes,
                               FrequencyTypes, RequestTypes, SwapTypes)
from adrates_tpu.trades.rates import OIS

from multibook_cases import VALUE_DT, build_model, trades_for

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def model():
    return build_model()


def _coll_ois(notional=10_000_000, tenor="5Y", coupon=0.039,
              swap_type=SwapTypes.RECEIVE):
    """A GBP OIS that the book will discount under USD collateral."""
    return OIS(VALUE_DT, tenor, swap_type, coupon,
               FrequencyTypes.ANNUAL, DayCountTypes.ACT_365F,
               CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
               notional=notional, float_dc_type=DayCountTypes.ACT_365F,
               bd_type=BusDayAdjustTypes.MODIFIED_FOLLOWING)


def _single_trade_book(model, trade):
    return compile_multibook([trade], model,
                             base_currency=CurrencyTypes.USD,
                             collateral_types=[CollateralType.USD])


class TestCollateralBook:
    def test_pv_matches_engine(self, model):
        trade = _coll_ois()
        mb = _single_trade_book(model, trade)
        fn = make_multibook_fn(mb, want_gamma=False)
        out = fn(mb.basket.quotes0, np.zeros((1, mb.basket.n_quotes)))
        pv_book = float(np.asarray(out["pvs"])[0, 0])

        res = trade.position(model).compute(
            [RequestTypes.VALUE], collateral_type=CollateralType.USD)
        assert res.value.currency == CurrencyTypes.USD
        assert pv_book == pytest.approx(res.value.amount, rel=1e-9,
                                        abs=1e-6)

    def test_delta_matches_engine_through_recalibration(self, model):
        """GBP-rate and basis-spread ladders of the collateralized book
        == the engine's per-trade ladders to 1e-8 (both views carry the
        GBP-rate chain through the XCCY re-bootstrap: chain_foreign in
        the engine, in-graph recalibration in the book)."""
        trade = _coll_ois()
        mb = _single_trade_book(model, trade)
        fn = make_multibook_fn(mb, want_gamma=False)
        out = fn(mb.basket.quotes0, np.zeros((1, mb.basket.n_quotes)))
        delta = np.asarray(out["delta"])[0]

        res = trade.position(model).compute(
            [RequestTypes.DELTA], collateral_type=CollateralType.USD)
        lad_ois = res.risk(CurveTypes.GBP_OIS_SONIA).risk_ladder
        lad_basis = res.risk(CurveTypes.GBP_USD_BASIS).risk_ladder

        sl_gbp = mb.basket.quote_slice("GBP_OIS_SONIA")
        sl_x = mb.basket.quote_slice("GBP_USD_XCCY")
        np.testing.assert_allclose(delta[sl_gbp] * 1e-4, lad_ois,
                                   rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(delta[sl_x] * 1e-4, lad_basis,
                                   rtol=1e-8, atol=1e-8)

    def test_full_delta_vs_fd(self, model):
        """Every live quote direction against central FD of the book PV.
        The DOMESTIC (USD) deltas are ~0 BY CONSTRUCTION here even in
        the full-recalibration view: the calibration basis swaps'
        domestic legs are zero-spread pure float legs with notional
        exchanges, which telescope to PV = 0 at any level of the USD
        curve (same projection and discount curve), so pv_dom carries no
        USD sensitivity — assert that instead of FD'ing a zero."""
        trade = _coll_ois()
        mb = _single_trade_book(model, trade)
        fn = make_multibook_fn(mb, want_gamma=False)
        q0 = np.asarray(mb.basket.quotes0)
        N = q0.shape[0]
        delta = np.asarray(fn(q0, np.zeros((1, N)))["delta"])[0]

        h = 1e-6
        sl_usd = mb.basket.quote_slice("USD_OIS_SOFR")
        sl_gbp = mb.basket.quote_slice("GBP_OIS_SONIA")
        sl_x = mb.basket.quote_slice("GBP_USD_XCCY")
        assert np.abs(delta[sl_usd]).max() < 1e-6   # telescoping pv_dom
        for j in [sl_gbp.start + 1, sl_gbp.start + 3,
                  sl_x.start, sl_x.start + 1]:
            sh = np.zeros((2, N))
            sh[0, j] = h
            sh[1, j] = -h
            pv = np.asarray(fn(q0, sh)["pvs"]).sum(axis=1)
            fd = (pv[0] - pv[1]) / (2 * h)
            assert delta[j] == pytest.approx(fd, rel=5e-6, abs=1e-3)

    def test_gamma_blocks_match_engine(self, model):
        """Own-curve gamma blocks and the rate x basis cross block vs the
        engine's per-trade matrices; full-book gamma symmetric; a
        diagonal element against second-difference FD."""
        trade = _coll_ois()
        mb = _single_trade_book(model, trade)
        fn = make_multibook_fn(mb, want_gamma=True)
        q0 = np.asarray(mb.basket.quotes0)
        N = q0.shape[0]
        out = fn(q0, np.zeros((1, N)))
        gamma = np.asarray(out["gamma"])[0]
        np.testing.assert_allclose(gamma, gamma.T, rtol=1e-9, atol=1e-6)

        res = trade.position(model).compute(
            [RequestTypes.GAMMA], collateral_type=CollateralType.USD)
        sl_gbp = mb.basket.quote_slice("GBP_OIS_SONIA")
        sl_x = mb.basket.quote_slice("GBP_USD_XCCY")
        np.testing.assert_allclose(
            gamma[sl_gbp, sl_gbp] * 1e-8,
            res.gamma(CurveTypes.GBP_OIS_SONIA).risk_ladder,
            rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(
            gamma[sl_x, sl_x] * 1e-8,
            res.gamma(CurveTypes.GBP_USD_BASIS).risk_ladder,
            rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(
            gamma[sl_gbp, sl_x] * 1e-8,
            res.gamma.cross_gamma(CurveTypes.GBP_OIS_SONIA,
                                  CurveTypes.GBP_USD_BASIS).risk_matrix,
            rtol=1e-8, atol=1e-8)

        # FD check of one diagonal element (GBP 5Y-ish pillar)
        j = sl_gbp.start + 3
        h = 5e-5
        sh = np.zeros((3, N))
        sh[0, j] = h
        sh[2, j] = -h
        pv = np.asarray(fn(q0, sh)["pvs"]).sum(axis=1)
        fd2 = (pv[0] - 2 * pv[1] + pv[2]) / (h * h)
        assert gamma[j, j] == pytest.approx(fd2, rel=5e-4, abs=1e-2)

    def test_mixed_book_pvs_and_ladders(self, model):
        """Natural + collateralized trades in ONE book: every PV matches
        its engine route; per-trade ladders sum to the book delta; the
        per-trade gamma machinery covers the collateralized trade."""
        natural = trades_for(model)
        coll = [_coll_ois(notional=7_500_000, tenor="7Y", coupon=0.037,
                          swap_type=SwapTypes.PAY),
                _coll_ois(notional=12_000_000, tenor="2Y", coupon=0.042)]
        trades = natural + coll
        colls = [None] * len(natural) + [CollateralType.USD] * len(coll)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.USD,
                               collateral_types=colls)
        fn = make_multibook_fn(mb, want_gamma=False)
        out = fn(mb.basket.quotes0, np.zeros((1, mb.basket.n_quotes)))
        pvs = np.asarray(out["pvs"])[0]

        for k, t in zip(range(len(natural), len(trades)), coll):
            res = t.position(model).compute(
                [RequestTypes.VALUE], collateral_type=CollateralType.USD)
            assert pvs[k] == pytest.approx(res.value.amount, rel=1e-9,
                                           abs=1e-6)

        per_trade = make_per_trade_delta_fn(mb, chunk=8)
        lad = np.asarray(per_trade(mb.basket.quotes0))
        np.testing.assert_allclose(lad.sum(axis=0),
                                   np.asarray(out["delta"])[0],
                                   rtol=1e-9, atol=1e-6)

        # collateralized trade's own ladder slices == its engine ladder
        res = coll[0].position(model).compute(
            [RequestTypes.DELTA], collateral_type=CollateralType.USD)
        k = len(natural)
        sl_gbp = mb.basket.quote_slice("GBP_OIS_SONIA")
        sl_x = mb.basket.quote_slice("GBP_USD_XCCY")
        np.testing.assert_allclose(
            lad[k][sl_gbp] * 1e-4,
            res.risk(CurveTypes.GBP_OIS_SONIA).risk_ladder,
            rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(
            lad[k][sl_x] * 1e-4,
            res.risk(CurveTypes.GBP_USD_BASIS).risk_ladder,
            rtol=1e-8, atol=1e-8)

        # exact per-trade gamma for the collateralized trade: GBP/basis
        # blocks match the engine's matrices
        per_g = make_per_trade_gamma_fn(mb, [k])
        gm = np.asarray(per_g(mb.basket.quotes0))[0]
        resg = coll[0].position(model).compute(
            [RequestTypes.GAMMA], collateral_type=CollateralType.USD)
        np.testing.assert_allclose(
            gm[sl_gbp, sl_gbp] * 1e-8,
            resg.gamma(CurveTypes.GBP_OIS_SONIA).risk_ladder,
            rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(
            gm[sl_x, sl_x] * 1e-8,
            resg.gamma(CurveTypes.GBP_USD_BASIS).risk_ladder,
            rtol=1e-8, atol=1e-8)

    def test_collateral_validation(self, model):
        """collateral_types must parallel instruments; a missing discount
        curve raises rather than silently mispricing."""
        from adrates_tpu.utils.error import LibError
        trade = _coll_ois()
        with pytest.raises(LibError):
            compile_multibook([trade, trade], model,
                              base_currency=CurrencyTypes.USD,
                              collateral_types=[CollateralType.USD])
        # EUR collateral: no GBP_EUR_XCCY curve in the model
        with pytest.raises(LibError):
            compile_multibook([trade], model,
                              base_currency=CurrencyTypes.USD,
                              collateral_types=[CollateralType.EUR])

    def test_natural_collateral_entry_is_noop(self, model):
        """A collateral entry matching the trade's own currency routes
        to the natural branch — identical book to collateral_types=None."""
        trade = _coll_ois()
        mb_nat = compile_multibook([trade], model,
                                   base_currency=CurrencyTypes.USD)
        mb_gbp = compile_multibook([trade], model,
                                   base_currency=CurrencyTypes.USD,
                                   collateral_types=[CollateralType.GBP])
        out_n = make_multibook_fn(mb_nat, want_gamma=False)(
            mb_nat.basket.quotes0, np.zeros((1, mb_nat.basket.n_quotes)))
        out_g = make_multibook_fn(mb_gbp, want_gamma=False)(
            mb_gbp.basket.quotes0, np.zeros((1, mb_gbp.basket.n_quotes)))
        np.testing.assert_allclose(np.asarray(out_n["pvs"]),
                                   np.asarray(out_g["pvs"]),
                                   rtol=1e-12, atol=1e-9)
