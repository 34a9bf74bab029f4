"""Block-sparse per-trade gamma matrices (parallel/pertrade_blocks.py).

The contract: for EVERY trade, the [k, k] own-block equals the dense
[N, N] per-trade gamma restricted to the block's quote indices, and the
dense complement is exactly zero (the block set is closed over XCCY
parents, so no truncation happens).
"""

import numpy as np
import pytest

from adrates_tpu.parallel import (compile_multibook, dense_from_block,
                                  make_multibook_fn,
                                  make_per_trade_gamma_blocks_fn,
                                  make_per_trade_gamma_fn, tile_multibook)
from adrates_tpu.utils import (CollateralType, CurrencyTypes, CurveTypes,
                               RequestTypes)

from multibook_cases import (build_model, build_model_infl, infl_trades_for,
                             trades_for)

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def model():
    return build_model()


@pytest.fixture(scope="module")
def model_infl():
    return build_model_infl()


def _dense_all(groups, n_trades, N):
    out = np.zeros((n_trades, N, N))
    for g in groups:
        for pos, t in enumerate(np.asarray(g.trade_ids)):
            out[t] += dense_from_block(g, pos, N)
    return out


class TestGammaBlocks:
    def test_blocks_match_dense_and_complement_zero(self, model):
        trades = trades_for(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        N = mb.basket.n_quotes
        fn = make_per_trade_gamma_blocks_fn(mb)
        groups = fn(mb.basket.quotes0)
        dense = np.asarray(make_per_trade_gamma_fn(
            mb, list(range(len(trades))))(mb.basket.quotes0))

        seen = set()
        for g in groups:
            for pos, t in enumerate(np.asarray(g.trade_ids)):
                seen.add(int(t))
                blk_dense = dense_from_block(g, pos, N)
                scale = max(np.abs(dense[t]).max(), 1.0)
                np.testing.assert_allclose(blk_dense, dense[t],
                                           rtol=1e-10,
                                           atol=1e-10 * scale)
                comp = dense[t].copy()
                comp[np.ix_(g.qidx, g.qidx)] = 0.0
                assert np.abs(comp).max() <= 1e-10 * scale
        assert seen == set(range(len(trades)))

    def test_blocks_sum_to_book_gamma(self, model):
        trades = trades_for(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        N = mb.basket.n_quotes
        groups = make_per_trade_gamma_blocks_fn(mb)(mb.basket.quotes0)
        total = _dense_all(groups, len(trades), N).sum(axis=0)
        out = make_multibook_fn(mb, want_gamma=True)(
            mb.basket.quotes0, np.zeros((1, N)))
        np.testing.assert_allclose(total, np.asarray(out["gamma"])[0],
                                   rtol=1e-9, atol=1e-5)

    def test_single_trade_matches_engine(self, model):
        """GBP OIS own-curve block == the engine's per-position gamma
        (reference shape engine.py:2563-2568) to 1e-8."""
        gbp_only = [t for t in trades_for(model)
                    if t.derivative_type.name == "OIS_SWAP"
                    and t._currency == CurrencyTypes.GBP]
        mb = compile_multibook(gbp_only, model,
                               base_currency=CurrencyTypes.GBP,
                               recalibrate_xccy=False)
        groups = make_per_trade_gamma_blocks_fn(mb)(mb.basket.quotes0)
        sl = mb.basket.quote_slice("GBP_OIS_SONIA")
        g = next(g for g in groups if 0 in np.asarray(g.trade_ids))
        pos = int(np.where(np.asarray(g.trade_ids) == 0)[0][0])
        dense = dense_from_block(g, pos, mb.basket.n_quotes)
        res = gbp_only[0].position(model).compute([RequestTypes.GAMMA])
        np.testing.assert_allclose(dense[sl, sl] * 1e-8,
                                   res.gamma.risk_ladder,
                                   rtol=1e-8, atol=1e-8)

    def test_lazy_tile_scales_blocks(self, model):
        trades = trades_for(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        B = len(trades)
        scale = np.array([1.0, 2.5, 0.3])
        lazy = tile_multibook(mb, 3, notional_scale=scale)
        groups = make_per_trade_gamma_blocks_fn(lazy)(
            mb.basket.quotes0)
        n_total = 0
        for g in groups:
            tids = np.asarray(g.trade_ids)
            n_total += tids.shape[0]
            blocks = np.asarray(g.blocks)
            for pos, t in enumerate(tids):
                c, b = int(t) // B, int(t) % B
                base_pos = int(np.where(tids == b)[0][0])
                ref = scale[c] * blocks[base_pos] / scale[0]
                atol = 1e-10 * max(np.abs(ref).max(), 1.0)
                np.testing.assert_allclose(blocks[pos], ref,
                                           rtol=1e-12, atol=atol)
        assert n_total == 3 * B

    def test_chunking_matches_unchunked(self, model):
        trades = trades_for(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        N = mb.basket.n_quotes
        a = _dense_all(make_per_trade_gamma_blocks_fn(mb)(
            mb.basket.quotes0), len(trades), N)
        b = _dense_all(make_per_trade_gamma_blocks_fn(mb, chunk=2)(
            mb.basket.quotes0), len(trades), N)
        scale = max(np.abs(a).max(), 1.0)
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12 * scale)

    def test_inflation_book(self, model_infl):
        trades = infl_trades_for(model_infl)
        mb = compile_multibook(trades, model_infl,
                               base_currency=CurrencyTypes.GBP)
        N = mb.basket.n_quotes
        groups = make_per_trade_gamma_blocks_fn(mb)(mb.basket.quotes0)
        dense = np.asarray(make_per_trade_gamma_fn(
            mb, list(range(len(trades))))(mb.basket.quotes0))
        total = _dense_all(groups, len(trades), N)
        scale = max(np.abs(dense).max(), 1.0)
        np.testing.assert_allclose(total, dense, rtol=1e-10,
                                   atol=1e-10 * scale)

    def test_collateralized_trade_block(self, model):
        """A USD-collateralized GBP OIS's block spans GBP rates + basis
        + USD rates (XCCY parent closure) and matches the dense
        per-trade gamma."""
        from multibook_cases import VALUE_DT
        from adrates_tpu.trades.rates import OIS
        from adrates_tpu.utils import (BusDayAdjustTypes, DayCountTypes,
                                       FrequencyTypes, SwapTypes)
        trade = OIS(VALUE_DT, "5Y", SwapTypes.RECEIVE, 0.039,
                    FrequencyTypes.ANNUAL, DayCountTypes.ACT_365F,
                    CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
                    notional=10_000_000,
                    float_dc_type=DayCountTypes.ACT_365F,
                    bd_type=BusDayAdjustTypes.MODIFIED_FOLLOWING)
        mb = compile_multibook([trade], model,
                               base_currency=CurrencyTypes.USD,
                               collateral_types=[CollateralType.USD])
        N = mb.basket.n_quotes
        groups = make_per_trade_gamma_blocks_fn(mb)(mb.basket.quotes0)
        assert len(groups) == 1
        g = groups[0]
        assert set(g.cids) == {mb.basket.curve_id("GBP_OIS_SONIA"),
                               mb.basket.curve_id("USD_OIS_SOFR"),
                               mb.basket.curve_id("GBP_USD_XCCY")}
        dense = np.asarray(make_per_trade_gamma_fn(mb, [0])(
            mb.basket.quotes0))[0]
        blk_dense = dense_from_block(g, 0, N)
        scale = max(np.abs(dense).max(), 1.0)
        np.testing.assert_allclose(blk_dense, dense, rtol=1e-10,
                                   atol=1e-10 * scale)
