"""Per-trade delta ladders and per-trade gamma matrices at book scale.

Split from test_multibook.py; builders in
multibook_cases.py.
"""

import numpy as np
import pytest

from adrates_tpu.parallel import (compile_multibook, make_multibook_fn,
                                  make_per_trade_delta_fn, tile_multibook)
from adrates_tpu.utils import CurrencyTypes, RequestTypes

from multibook_cases import (build_model, build_model_infl, infl_trades_for,
                             trades_for)

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def model():
    return build_model()


@pytest.fixture(scope="module")
def model_infl():
    return build_model_infl()


_trades = trades_for
_infl_trades = infl_trades_for


class TestPerTradeDelta:
    def test_rows_sum_to_book_delta(self, model):
        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        per_trade = make_per_trade_delta_fn(mb, chunk=4)
        lad = np.asarray(per_trade(mb.basket.quotes0))
        assert lad.shape == (len(trades), mb.basket.n_quotes)

        fn = make_multibook_fn(mb, want_gamma=False)
        out = fn(mb.basket.quotes0,
                 np.zeros((1, mb.basket.n_quotes)))
        np.testing.assert_allclose(lad.sum(axis=0),
                                   np.asarray(out["delta"])[0],
                                   rtol=1e-9, atol=1e-6)

    def test_matmul_method_matches_gather(self, model):
        """The dense scatter+MXU-matmul contraction is the same math as
        the gather einsum — identical ladders to f64 noise."""
        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        lad_g = np.asarray(
            make_per_trade_delta_fn(mb, chunk=4)(mb.basket.quotes0))
        lad_m = np.asarray(
            make_per_trade_delta_fn(mb, chunk=4, method="matmul")(
                mb.basket.quotes0))
        # atol covers f64 reassociation noise between the two
        # contraction orders on ~1e6-scale ladder entries
        np.testing.assert_allclose(lad_m, lad_g, rtol=1e-12, atol=1e-7)

        with pytest.raises(ValueError):
            make_per_trade_delta_fn(mb, method="bogus")

    def test_f32_ladders_within_reporting_tolerance(self, model):
        import jax.numpy as jnp
        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        lad64 = np.asarray(
            make_per_trade_delta_fn(mb, chunk=4)(mb.basket.quotes0))
        for meth in ("gather", "matmul"):
            lad32 = np.asarray(
                make_per_trade_delta_fn(mb, chunk=4, dtype=jnp.float32,
                                        method=meth)(mb.basket.quotes0))
            assert lad32.dtype == np.float32
            scale = np.abs(lad64).max()
            np.testing.assert_allclose(lad32, lad64, rtol=1e-4,
                                       atol=3e-6 * scale)

    def test_single_trade_ladder_matches_engine(self, model):
        gbp_only = [t for t in _trades(model)
                    if t.derivative_type.name == "OIS_SWAP"
                    and t._currency == CurrencyTypes.GBP]
        mb = compile_multibook(gbp_only, model,
                               base_currency=CurrencyTypes.GBP,
                               recalibrate_xccy=False)
        per_trade = make_per_trade_delta_fn(mb, chunk=2)
        lad = np.asarray(per_trade(mb.basket.quotes0))
        sl = mb.basket.quote_slice("GBP_OIS_SONIA")
        res = gbp_only[0].position(model).compute([RequestTypes.DELTA])
        np.testing.assert_allclose(lad[0][sl] * 1e-4,
                                   res.risk.risk_ladder,
                                   rtol=1e-9, atol=1e-8)


class TestPerTradeGamma:
    def test_sums_to_book_gamma(self, model):
        """Per-trade gamma matrices over ALL trades sum to the book
        gamma (both from independent closed-form paths)."""
        from adrates_tpu.parallel import make_per_trade_gamma_fn
        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        per = make_per_trade_gamma_fn(mb, list(range(len(trades))))
        gm = np.asarray(per(mb.basket.quotes0))
        assert gm.shape == (len(trades), mb.basket.n_quotes,
                            mb.basket.n_quotes)
        fn = make_multibook_fn(mb, want_gamma=True)
        out = fn(mb.basket.quotes0, np.zeros((1, mb.basket.n_quotes)))
        np.testing.assert_allclose(gm.sum(axis=0),
                                   np.asarray(out["gamma"])[0],
                                   rtol=1e-9, atol=1e-5)

    def test_single_trade_matches_engine(self, model):
        """One OIS trade's gamma block (its own curve) == the engine's
        per-position gamma matrix (reference shape:
        engine.py:2563-2568)."""
        from adrates_tpu.parallel import make_per_trade_gamma_fn
        gbp_only = [t for t in _trades(model)
                    if t.derivative_type.name == "OIS_SWAP"
                    and t._currency == CurrencyTypes.GBP]
        mb = compile_multibook(gbp_only, model,
                               base_currency=CurrencyTypes.GBP,
                               recalibrate_xccy=False)
        per = make_per_trade_gamma_fn(mb, [0])
        gm = np.asarray(per(mb.basket.quotes0))[0]
        sl = mb.basket.quote_slice("GBP_OIS_SONIA")
        res = gbp_only[0].position(model).compute([RequestTypes.GAMMA])
        np.testing.assert_allclose(gm[sl, sl] * 1e-8,
                                   res.gamma.risk_ladder,
                                   rtol=1e-8, atol=1e-8)

    def test_inflation_book_sums(self, model_infl):
        """Per-trade gammas on a ZCIS/YoY book (inflation-factor curve
        rows + breakeven quotes) sum to the book gamma."""
        from adrates_tpu.parallel import make_per_trade_gamma_fn
        trades = _infl_trades(model_infl)
        mb = compile_multibook(trades, model_infl,
                               base_currency=CurrencyTypes.GBP)
        per = make_per_trade_gamma_fn(mb, list(range(len(trades))))
        gm = np.asarray(per(mb.basket.quotes0))
        fn = make_multibook_fn(mb, want_gamma=True)
        out = fn(mb.basket.quotes0, np.zeros((1, mb.basket.n_quotes)))
        np.testing.assert_allclose(gm.sum(axis=0),
                                   np.asarray(out["gamma"])[0],
                                   rtol=1e-9, atol=1e-5)

    def test_lazy_tile_selection(self, model):
        """Selecting the same base trade from different lazy copies
        scales its gamma by the copy's notional multiplier."""
        from adrates_tpu.parallel import make_per_trade_gamma_fn
        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        B = len(trades)
        lazy = tile_multibook(mb, 2,
                              notional_scale=np.array([1.0, 2.5]))
        per = make_per_trade_gamma_fn(lazy, [0, B])
        gm = np.asarray(per(mb.basket.quotes0))
        # atol rides on gamma magnitude ~4e8 (unit-rate² units): 1e-5
        # is f64 noise
        np.testing.assert_allclose(gm[1], 2.5 * gm[0],
                                   rtol=1e-12, atol=1e-5)
