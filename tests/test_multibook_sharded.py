"""Sharded (GSPMD) multibook analytics + the structured per-stage risk
pass, on the virtual 8-device CPU mesh.

Split from test_multibook.py; builders in
multibook_cases.py.
"""

import numpy as np
import pytest

from adrates_tpu.parallel import (compile_multibook, make_multibook_fn,
                                  tile_multibook)
from adrates_tpu.utils import CurrencyTypes

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


class TestShardedMultibook:
    @staticmethod
    def _check(out, ref):
        np.testing.assert_allclose(
            np.asarray(out["total_pv"]),
            np.asarray(ref["pvs"]).sum(axis=1), rtol=1e-12, atol=1e-7)
        np.testing.assert_allclose(np.asarray(out["delta"]),
                                   np.asarray(ref["delta"]),
                                   rtol=1e-10, atol=1e-7)
        np.testing.assert_allclose(np.asarray(out["gamma"]),
                                   np.asarray(ref["gamma"]),
                                   rtol=1e-10, atol=1e-6)

    def test_sharded_equals_single_device(self, model):
        """GSPMD row-sharded analytics == unsharded on the virtual
        8-device CPU mesh: total PV, delta and gamma to f64 noise.
        Tiled x5 so NO row count divides the 8-way mesh — the padding
        path is what runs."""
        import jax
        from jax.sharding import Mesh

        from adrates_tpu.parallel import (make_sharded_multibook_fn,
                                          shard_multibook)

        devices = jax.devices()
        if len(devices) < 8:
            pytest.skip("needs the 8-device virtual CPU mesh")
        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        mbb = tile_multibook(mb, 5, materialize=True)
        N = mb.basket.n_quotes
        shocks = np.zeros((2, N))
        shocks[1, 2] = 1e-4

        ref = make_multibook_fn(mbb, want_gamma=True)(
            mb.basket.quotes0, shocks)

        mesh = Mesh(np.array(devices[:8]), ("book",))
        fn = make_sharded_multibook_fn(shard_multibook(mbb, mesh), mesh,
                                       want_gamma=True)
        self._check(fn(mb.basket.quotes0, shocks), ref)

    def test_lazy_tile_sharded_no_host_materialization(self, model):
        """A lazy TileSpec book goes straight into
        make_sharded_multibook_fn: base rows replicate, the jitted
        expansion outputs SHARDED full-size rows, results match the
        unsharded materialized reference."""
        import jax
        from jax.sharding import Mesh

        from adrates_tpu.parallel import make_sharded_multibook_fn

        devices = jax.devices()
        if len(devices) < 8:
            pytest.skip("needs the 8-device virtual CPU mesh")
        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        scale = np.array([1.0, 1.5, 0.5])
        lazy = tile_multibook(mb, 3, notional_scale=scale)
        mat = tile_multibook(mb, 3, notional_scale=scale,
                             materialize=True)
        assert lazy.tile is not None
        N = mb.basket.n_quotes
        shocks = np.zeros((2, N))
        shocks[1, -1] = 1e-4

        ref = make_multibook_fn(mat, want_gamma=True)(
            mb.basket.quotes0, shocks)
        mesh = Mesh(np.array(devices[:8]), ("book",))
        fn = make_sharded_multibook_fn(lazy, mesh, want_gamma=True)
        self._check(fn(mb.basket.quotes0, shocks), ref)

    def test_2d_dcn_mesh(self, model):
        """Rows shard over BOTH axes of a (host=2, book=4) mesh — the
        multi-host layout compiled and executed on the virtual CPU
        mesh."""
        import jax
        from jax.sharding import Mesh

        from adrates_tpu.parallel import (make_sharded_multibook_fn,
                                          shard_multibook)

        devices = jax.devices()
        if len(devices) < 8:
            pytest.skip("needs the 8-device virtual CPU mesh")
        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        mbb = tile_multibook(mb, 3, materialize=True)
        N = mb.basket.n_quotes
        shocks = np.zeros((1, N))

        ref = make_multibook_fn(mbb, want_gamma=True)(
            mb.basket.quotes0, shocks)
        mesh = Mesh(np.array(devices[:8]).reshape(2, 4), ("host", "book"))
        sharded = shard_multibook(mbb, mesh, axis=("host", "book"))
        fn = make_sharded_multibook_fn(sharded, mesh,
                                       axis=("host", "book"),
                                       want_gamma=True)
        self._check(fn(mb.basket.quotes0, shocks), ref)


class TestShardedPerTrade:
    """Mesh-sharded per-trade risk (parallel/pertrade_sharded.py):
    ladders and selected gammas computed with rows /
    the selection split over the 8-device mesh must match the
    single-device builders to f64 summation noise."""

    @staticmethod
    def _mesh():
        import jax
        from jax.sharding import Mesh

        devices = jax.devices()
        if len(devices) < 8:
            pytest.skip("needs the 8-device virtual CPU mesh")
        return Mesh(np.array(devices[:8]), ("book",))

    def test_sharded_delta_lazy_tile(self, model):
        """Lazy x5 tile (no row count divides 8): sharded ladders ==
        single-device, rows expanded straight into shards."""
        from adrates_tpu.parallel import (make_per_trade_delta_fn,
                                          make_sharded_per_trade_delta_fn)

        mesh = self._mesh()
        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        mbt = tile_multibook(mb, 5)
        assert mbt.tile is not None
        q0 = np.asarray(mb.basket.quotes0)

        ref = np.asarray(make_per_trade_delta_fn(mbt)(q0))
        fn = make_sharded_per_trade_delta_fn(mbt, mesh)
        out = np.asarray(fn(q0))
        assert out.shape[0] % 8 == 0
        out = out[:fn.n_trades]
        scale = np.abs(ref).max() + 1.0
        np.testing.assert_allclose(out, ref, rtol=1e-12,
                                   atol=1e-13 * scale)

    def test_sharded_delta_materialized(self, model):
        from adrates_tpu.parallel import (make_per_trade_delta_fn,
                                          make_sharded_per_trade_delta_fn)

        mesh = self._mesh()
        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        q0 = np.asarray(mb.basket.quotes0)
        ref = np.asarray(make_per_trade_delta_fn(mb)(q0))
        fn = make_sharded_per_trade_delta_fn(mb, mesh)
        out = np.asarray(fn(q0))[:fn.n_trades]
        scale = np.abs(ref).max() + 1.0
        np.testing.assert_allclose(out, ref, rtol=1e-12,
                                   atol=1e-13 * scale)

    def test_sharded_gamma_blocks_full_book(self, model):
        """FULL-book block gammas with each signature group's base
        trades split over the mesh must match
        the single-device builder group by group: same signatures, same
        quote maps, same trade ids, blocks to f64 noise. Lazy x5 tile
        exercises the notional broadcast on sharded base blocks."""
        from adrates_tpu.parallel import (
            make_per_trade_gamma_blocks_fn,
            make_sharded_per_trade_gamma_blocks_fn)

        mesh = self._mesh()
        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        mbt = tile_multibook(mb, 5)
        q0 = np.asarray(mb.basket.quotes0)

        ref_groups = make_per_trade_gamma_blocks_fn(mbt)(q0)
        out_groups = make_sharded_per_trade_gamma_blocks_fn(
            mbt, mesh)(q0)
        assert len(out_groups) == len(ref_groups)
        for rg, og in zip(ref_groups, out_groups):
            assert og.cids == rg.cids
            np.testing.assert_array_equal(og.qidx, rg.qidx)
            np.testing.assert_array_equal(og.trade_ids, rg.trade_ids)
            rb = np.asarray(rg.blocks)
            ob = np.asarray(og.blocks)
            assert ob.shape == rb.shape
            scale = np.abs(rb).max() + 1.0
            np.testing.assert_allclose(ob, rb, rtol=1e-9,
                                       atol=1e-12 * scale)

    def test_sharded_gamma_selection(self, model):
        """11 selected trades (not divisible by 8 -> pad chunks) across
        the mesh match the single-device exact gammas."""
        from adrates_tpu.parallel import (make_per_trade_gamma_fn,
                                          make_sharded_per_trade_gamma_fn)

        mesh = self._mesh()
        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        mbt = tile_multibook(mb, 5)
        q0 = np.asarray(mb.basket.quotes0)
        B = mbt.n_trades
        sel = np.linspace(0, B - 1, 11).astype(int)

        ref = np.asarray(make_per_trade_gamma_fn(mbt, sel)(q0))
        out = np.asarray(
            make_sharded_per_trade_gamma_fn(mbt, mesh, sel)(q0))
        assert out.shape == ref.shape
        # different per-device summation order: scale-relative f64 noise
        scale = np.abs(ref).max() + 1.0
        np.testing.assert_allclose(out, ref, rtol=1e-9,
                                   atol=1e-12 * scale)


class TestStructuredRisk:
    """The per-stage structured risk pass (parallel/structured_risk.py)
    must reproduce the generic full-graph closed-form split exactly:
    same J (delta bitwise), same gamma to f64 contraction noise."""

    def _compare(self, mb, shock_vec):
        import jax
        import jax.numpy as jnp

        from adrates_tpu.parallel.multibook import _scenario_risk
        from adrates_tpu.parallel.structured_risk import \
            make_structured_risk

        grids = mb.basket.grids
        params = jax.device_put(mb.basket.params)
        agg = jax.device_put(mb.aggregate)
        cl = jax.device_put(mb.clamp) if mb.clamp is not None else None
        q = jnp.asarray(mb.basket.quotes0) + jnp.asarray(shock_vec)
        struct = make_structured_risk(mb.basket)
        a = jax.jit(lambda qq: _scenario_risk(grids, qq, params, agg,
                                              cl, True))(q)
        b = jax.jit(lambda qq: struct(qq, params, agg, cl, True))(q)
        da, db = np.asarray(a["delta"]), np.asarray(b["delta"])
        assert not np.isnan(db).any()
        np.testing.assert_allclose(db, da, rtol=1e-9,
                                   atol=1e-9 * (np.abs(da).max() + 1))
        ga, gb = np.asarray(a["gamma"]), np.asarray(b["gamma"])
        assert not np.isnan(gb).any()
        np.testing.assert_allclose(gb, ga, rtol=1e-7,
                                   atol=1e-8 * (np.abs(ga).max() + 1))

    def test_multi_currency_book(self, model):
        trades = _trades(model)
        mb = compile_multibook(trades, model,
                               base_currency=CurrencyTypes.GBP)
        rng = np.random.default_rng(11)
        self._compare(mb, np.zeros(mb.basket.n_quotes))
        self._compare(mb, rng.normal(0, 1e-3, mb.basket.n_quotes))

    def test_inflation_book(self, model_infl):
        trades = _infl_trades(model_infl)
        mb = compile_multibook(trades, model_infl,
                               base_currency=CurrencyTypes.GBP)
        self._compare(mb, np.zeros(mb.basket.n_quotes))
