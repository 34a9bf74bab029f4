"""Multi-currency multi-curve book: parity against the per-trade engine
and direct valuation, FD-validated deltas, tiling, inflation books.

Reference semantics being matched at book scale:
/root/reference/cavour/market/position/engine.py:2639-2728 (dual-curve
float legs), 1411-1988 (XCCY discounting), 700-984 (FRN), 505-698 (bond).

Split from test_multibook.py; shared builders in
multibook_cases.py. Per-trade ladders/gammas: test_multibook_pertrade.py;
sharded/structured: test_multibook_sharded.py.
"""

import numpy as np
import pytest

from adrates_tpu.parallel import (compile_multibook, make_multibook_fn,
                                  make_per_trade_delta_fn, tile_multibook)
from adrates_tpu.utils import CurrencyTypes, CurveTypes, RequestTypes

from multibook_cases import (build_model, build_model_infl, direct_pvs_gbp,
                             infl_trades_for, trades_for)

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def model():
    return build_model()


@pytest.fixture(scope="module")
def model_infl():
    return build_model_infl()


_trades = trades_for
_infl_trades = infl_trades_for
_direct_pvs_gbp = direct_pvs_gbp


class TestMultiBookParity:
    def test_pvs_match_direct(self, model):
        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        fn = make_multibook_fn(mb, want_gamma=False)
        shocks = np.zeros((1, mb.basket.n_quotes))
        out = fn(mb.basket.quotes0, shocks)
        pvs = np.asarray(out["pvs"])[0]
        direct = _direct_pvs_gbp(model, trades)
        np.testing.assert_allclose(pvs, direct, rtol=1e-10, atol=1e-6)

    def test_aggregate_equals_sum(self, model):
        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        fn = make_multibook_fn(mb, want_gamma=False)
        import jax.numpy as jnp
        from adrates_tpu.parallel import aggregate_total
        import jax
        dfs = mb.basket.grids(jnp.asarray(mb.basket.quotes0),
                              jax.device_put(mb.basket.params))
        total = float(aggregate_total(dfs, jax.device_put(mb.aggregate),
                                      jax.device_put(mb.clamp)))
        out = fn(mb.basket.quotes0, np.zeros((1, mb.basket.n_quotes)))
        assert total == pytest.approx(float(np.sum(out["pvs"][0])),
                                      rel=1e-12, abs=1e-6)

    def test_pv_dom_parity(self, model):
        """The in-graph domestic calibration-leg PVs must reproduce the
        stored _pv_domestic (engine == direct contract at the basket
        level) — the base-quote XCCY grid then matches the stored curve."""
        import jax
        import jax.numpy as jnp
        mb = compile_multibook(_trades(model), model,
                               base_currency=CurrencyTypes.GBP)
        basket = mb.basket
        native = basket.native_grids_fn()
        grids = jax.jit(native)(jnp.asarray(basket.quotes0),
                                jax.device_put(basket.params))
        xid = basket.curve_id("GBP_USD_XCCY")
        xcurve = basket.curves[xid]
        np.testing.assert_allclose(np.asarray(grids[xid][1]),
                                   np.asarray(xcurve._dfs),
                                   rtol=1e-12, atol=1e-12)

    def test_delta_vs_fd(self, model):
        """Book delta (full recalibration view) == central FD of the book
        PV under shocked quotes, for a rate pillar AND a basis pillar."""
        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        fn = make_multibook_fn(mb, want_gamma=False)
        q0 = np.asarray(mb.basket.quotes0)
        N = q0.shape[0]
        out = fn(q0, np.zeros((1, N)))
        delta = np.asarray(out["delta"])[0]

        h = 1e-6
        sl_gbp = mb.basket.quote_slice("GBP_OIS_SONIA")
        sl_x = mb.basket.quote_slice("GBP_USD_XCCY")
        for j in [sl_gbp.start + 3, sl_x.start + 1,
                  mb.basket.quote_slice("USD_OIS_SOFR").start + 2]:
            sh = np.zeros((2, N))
            sh[0, j] = h
            sh[1, j] = -h
            pv = np.asarray(fn(q0, sh)["pvs"]).sum(axis=1)
            fd = (pv[0] - pv[1]) / (2 * h)
            assert delta[j] == pytest.approx(fd, rel=5e-7, abs=1e-4)

    def test_gamma_symmetry(self, model):
        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        fn = make_multibook_fn(mb, want_gamma=True)
        out = fn(mb.basket.quotes0,
                 np.zeros((1, mb.basket.n_quotes)))
        g = np.asarray(out["gamma"])[0]
        np.testing.assert_allclose(g, g.T, rtol=1e-9, atol=1e-6)

    def test_closed_form_gamma_matches_ad_tower(self, model):
        """The production closed-form split (Jᵀ·H_agg·J + curve-Hessian
        contraction, `_scenario_risk`) must equal a plain jacfwd∘jacrev
        tower of the aggregate to f64 noise — including the clamp slots'
        second-order block and at a shocked point."""
        import jax
        import jax.numpy as jnp
        from adrates_tpu.parallel.multibook import (_agg_clamp,
                                                    _scenario_risk,
                                                    aggregate_total)

        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        basket = mb.basket
        grids = basket.grids
        params = jax.device_put(basket.params)
        agg = jax.device_put(mb.aggregate)
        clamp = jax.device_put(mb.clamp)
        cl_agg = _agg_clamp(clamp, mb.tile)
        q0 = jnp.asarray(basket.quotes0)
        shock = np.zeros(basket.n_quotes)
        shock[1] = 2e-4
        shock[-2] = -1e-4
        q = q0 + jnp.asarray(shock)

        out = jax.jit(lambda qq: _scenario_risk(
            grids, qq, params, agg, cl_agg, True))(q)

        total = lambda qq: aggregate_total(grids(qq, params), agg, cl_agg)
        delta_ref = jax.jacrev(total)(q)
        gamma_ref = jax.jacfwd(jax.jacrev(total))(q)
        np.testing.assert_allclose(np.asarray(out["delta"]),
                                   np.asarray(delta_ref),
                                   rtol=1e-11, atol=1e-7)
        np.testing.assert_allclose(np.asarray(out["gamma"]),
                                   np.asarray(gamma_ref),
                                   rtol=1e-9, atol=1e-5)

    def test_engine_view_deltas_match_per_trade_engine(self, model):
        """With recalibrate_xccy=False the basket reproduces the per-trade
        engine's risk views: a GBP-only OIS book's GBP ladder equals the
        engine's delta ladder."""
        gbp_only = [t for t in _trades(model)
                    if t.derivative_type.name == "OIS_SWAP"
                    and t._currency == CurrencyTypes.GBP]
        mb = compile_multibook(gbp_only, model,
                               base_currency=CurrencyTypes.GBP,
                               recalibrate_xccy=False)
        fn = make_multibook_fn(mb, want_gamma=False)
        out = fn(mb.basket.quotes0,
                 np.zeros((1, mb.basket.n_quotes)))
        sl = mb.basket.quote_slice("GBP_OIS_SONIA")
        book_ladder = np.asarray(out["delta"])[0][sl] * 1e-4

        res = gbp_only[0].position(model).compute([RequestTypes.DELTA])
        np.testing.assert_allclose(book_ladder, res.risk.risk_ladder,
                                   rtol=1e-9, atol=1e-8)


class TestTileMultibook:
    def test_tiled_pvs(self, model):
        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        scale = np.array([1.0, 2.0, 0.5])
        mb3 = tile_multibook(mb, 3, notional_scale=scale)
        fn = make_multibook_fn(mb3, want_gamma=False)
        out = fn(mb3.basket.quotes0,
                 np.zeros((1, mb3.basket.n_quotes)))
        pvs = np.asarray(out["pvs"])[0].reshape(3, len(trades))
        np.testing.assert_allclose(pvs[1], 2.0 * pvs[0], rtol=1e-12)
        np.testing.assert_allclose(pvs[2], 0.5 * pvs[0], rtol=1e-12)

    def test_lazy_matches_materialized(self, model):
        """Device-side tile expansion == host-materialized tiling for
        per-trade PVs, book delta AND gamma (the lazy path scales the
        aggregate/clamp weights analytically)."""
        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        scale = np.array([1.0, 1.7, 0.4, 2.2])
        lazy = tile_multibook(mb, 4, notional_scale=scale)
        mat = tile_multibook(mb, 4, notional_scale=scale,
                             materialize=True)
        assert lazy.tile is not None and mat.tile is None
        shocks = np.zeros((1, mb.basket.n_quotes))
        shocks[0, 3] = 1e-4
        out_l = make_multibook_fn(lazy, want_gamma=True)(
            mb.basket.quotes0, shocks)
        out_m = make_multibook_fn(mat, want_gamma=True)(
            mb.basket.quotes0, shocks)
        np.testing.assert_allclose(np.asarray(out_l["pvs"]),
                                   np.asarray(out_m["pvs"]),
                                   rtol=1e-12, atol=1e-9)
        # atol rides on ladder magnitude ~1e8: 1e-7 is f64 noise (the
        # lazy path scales clamp weights analytically, the materialized
        # path sums expanded slots — same value, different rounding)
        np.testing.assert_allclose(np.asarray(out_l["delta"]),
                                   np.asarray(out_m["delta"]),
                                   rtol=1e-10, atol=1e-7)
        # gamma assembly sums terms of ladder scale (~1e8): reordering
        # noise is ~max|delta|*eps*sqrt(n_terms) ≈ 1e-6, so anchor the
        # absolute floor to the measured ladder magnitude — CAPPED at
        # 1e-5 so the loosening stays bounded regardless of future
        # ladder growth (the scaled atol must not silently
        # weaken the assembly-equivalence check; cap introduced with the
        # summation-order change that moved gamma assembly to the
        # structured per-stage pass)
        gamma_atol = min(max(1e-9, np.abs(np.asarray(out_m["delta"])).max()
                             * 1e-13), 1e-5)
        np.testing.assert_allclose(np.asarray(out_l["gamma"]),
                                   np.asarray(out_m["gamma"]),
                                   rtol=1e-10, atol=gamma_atol)
        lad_l = np.asarray(make_per_trade_delta_fn(lazy)(
            mb.basket.quotes0))
        lad_m = np.asarray(make_per_trade_delta_fn(mat)(
            mb.basket.quotes0))
        np.testing.assert_allclose(lad_l, lad_m, rtol=1e-10, atol=1e-8)


class TestInflationBook:
    """ZCIS/YoY at book scale: breakevens ride inside the packed quote
    vector; PV/delta/gamma parity vs the
    per-trade engine and FD."""

    def test_quotes_include_breakevens(self, model_infl):
        mb = compile_multibook(_infl_trades(model_infl), model_infl,
                               base_currency=CurrencyTypes.GBP)
        sl = mb.basket.quote_slice("GBP_RPI_INFLATION")
        assert sl.stop - sl.start == 5
        np.testing.assert_allclose(
            np.asarray(mb.basket.quotes0)[sl],
            np.asarray([3.8, 3.5, 3.4, 3.5, 3.3]) / 100.0)

    def test_pvs_match_engine(self, model_infl):
        trades = _infl_trades(model_infl)
        mb = compile_multibook(trades, model_infl,
                               base_currency=CurrencyTypes.GBP)
        fn = make_multibook_fn(mb, want_gamma=False)
        out = fn(mb.basket.quotes0, np.zeros((1, mb.basket.n_quotes)))
        pvs = np.asarray(out["pvs"])[0]
        for k, t in enumerate(trades):
            res = t.position(model_infl).compute([RequestTypes.VALUE])
            assert pvs[k] == pytest.approx(res.value.amount, rel=1e-10,
                                           abs=1e-6)

    def test_deltas_match_engine(self, model_infl):
        trades = _infl_trades(model_infl)
        for t in trades[:2]:            # zcis, yoy
            mb = compile_multibook([t], model_infl,
                                   base_currency=CurrencyTypes.GBP)
            fn = make_multibook_fn(mb, want_gamma=True)
            out = fn(mb.basket.quotes0,
                     np.zeros((1, mb.basket.n_quotes)))
            delta = np.asarray(out["delta"])[0]
            sl_o = mb.basket.quote_slice("GBP_OIS_SONIA")
            sl_i = mb.basket.quote_slice("GBP_RPI_INFLATION")
            res = t.position(model_infl).compute(
                [RequestTypes.DELTA, RequestTypes.GAMMA])
            np.testing.assert_allclose(
                delta[sl_o] * 1e-4,
                res.risk(CurveTypes.GBP_OIS_SONIA).risk_ladder,
                rtol=1e-8, atol=1e-7)
            np.testing.assert_allclose(
                delta[sl_i] * 1e-4,
                res.risk(CurveTypes.GBP_RPI_INFLATION).risk_ladder,
                rtol=1e-8, atol=1e-7)
            gamma = np.asarray(out["gamma"])[0]
            np.testing.assert_allclose(
                gamma[sl_i, sl_i] * 1e-8,
                res.gamma(CurveTypes.GBP_RPI_INFLATION).risk_ladder,
                rtol=1e-7, atol=1e-7)
            np.testing.assert_allclose(
                gamma[sl_o, sl_i] * 1e-8,
                res.gamma.cross_gamma(
                    CurveTypes.GBP_OIS_SONIA,
                    CurveTypes.GBP_RPI_INFLATION).risk_matrix,
                rtol=1e-7, atol=1e-7)

    def test_breakeven_delta_vs_fd(self, model_infl):
        trades = _infl_trades(model_infl)
        mb = compile_multibook(trades, model_infl,
                               base_currency=CurrencyTypes.GBP)
        fn = make_multibook_fn(mb, want_gamma=False)
        q0 = np.asarray(mb.basket.quotes0)
        N = q0.shape[0]
        delta = np.asarray(fn(q0, np.zeros((1, N)))["delta"])[0]
        sl = mb.basket.quote_slice("GBP_RPI_INFLATION")
        h = 1e-6
        for j in [sl.start + 1, sl.start + 2]:
            sh = np.zeros((2, N))
            sh[0, j] = h
            sh[1, j] = -h
            pv = np.asarray(fn(q0, sh)["pvs"]).sum(axis=1)
            fd = (pv[0] - pv[1]) / (2 * h)
            assert delta[j] == pytest.approx(fd, rel=5e-6, abs=1e-3)


class TestBookSpeed:
    """Book-scale SPEED (third-order) — make_multibook_speed_fn is the
    exact AD tower over the aggregate graph (the reference defines the SPEED enum but never implements it)."""

    def test_speed_vs_fd_of_gamma(self, model):
        from adrates_tpu.parallel import make_multibook_speed_fn

        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        q0 = np.asarray(mb.basket.quotes0)
        N = q0.shape[0]
        speed = np.asarray(make_multibook_speed_fn(mb)(q0))
        assert speed.shape == (N, N, N)
        assert np.isfinite(speed).all()
        # fully symmetric in all index permutations (to f64 noise at
        # the tensor's own magnitude — entries reach ~1e7)
        sym_atol = 1e-12 * (np.abs(speed).max() + 1.0)
        np.testing.assert_allclose(speed, np.swapaxes(speed, 0, 1),
                                   rtol=1e-9, atol=sym_atol)
        np.testing.assert_allclose(speed, np.swapaxes(speed, 1, 2),
                                   rtol=1e-9, atol=sym_atol)

        # central FD of the book gamma along two quote directions
        fn = make_multibook_fn(mb, want_gamma=True)
        h = 1e-5
        scale = np.abs(speed).max() + 1.0
        for k in [1, N - 2]:
            sh = np.zeros((2, N))
            sh[0, k] = h
            sh[1, k] = -h
            g = np.asarray(fn(q0, sh)["gamma"])
            fd = (g[0] - g[1]) / (2 * h)
            np.testing.assert_allclose(
                speed[:, :, k], fd, rtol=5e-4, atol=1e-6 * scale)

    def test_speed_guard_at_large_n(self, model, monkeypatch):
        """Above SPEED_MAX_QUOTES quotes the builder raises (a
        flagship-size basket must get an error, not an
        unbounded compile); force=True overrides."""
        from adrates_tpu.parallel import make_multibook_speed_fn
        from adrates_tpu.parallel import multibook as mbmod
        from adrates_tpu.utils import LibError

        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        # shrink the threshold below this basket's N to exercise the
        # guard without building a 184-quote flagship model in tests
        monkeypatch.setattr(mbmod, "SPEED_MAX_QUOTES",
                            mb.basket.n_quotes - 1)
        with pytest.raises(LibError, match="force=True"):
            make_multibook_speed_fn(mb)
        fn = make_multibook_speed_fn(mb, force=True)   # builds, no raise
        assert callable(fn)
        # at N <= threshold the builder succeeds unguarded
        monkeypatch.setattr(mbmod, "SPEED_MAX_QUOTES",
                            mb.basket.n_quotes)
        assert callable(make_multibook_speed_fn(mb))

    def test_speed_tile_linearity(self, model):
        """Tiled x3 with notional scales: speed scales by sum(scale) —
        third-order risk is linear in notional like every PV measure."""
        from adrates_tpu.parallel import make_multibook_speed_fn

        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        q0 = np.asarray(mb.basket.quotes0)
        base = np.asarray(make_multibook_speed_fn(mb)(q0))
        scale = np.array([1.0, 2.0, 0.5])
        tiled = tile_multibook(mb, 3, notional_scale=scale)
        sp_t = np.asarray(make_multibook_speed_fn(tiled)(q0))
        np.testing.assert_allclose(
            sp_t, scale.sum() * base, rtol=1e-9,
            atol=1e-10 * (np.abs(base).max() + 1.0))
