"""Book-scale batched pricing and mesh sharding.

Runs on a virtual 8-device CPU mesh (conftest sets
xla_force_host_platform_device_count=8) — the same code path the driver
dry-runs for multi-chip validation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from adrates_tpu.utils import (BusDayAdjustTypes, CurrencyTypes, CurveTypes,
                               Date, DayCountTypes, FrequencyTypes,
                               RequestTypes, SwapTypes)
from adrates_tpu.models import Model
from adrates_tpu.parallel import (aggregate_book, compile_book,
                                  make_book_fn, make_sharded_book_fn,
                                  shard_book, tile_book)
from adrates_tpu.trades.rates import OIS

pytestmark = pytest.mark.slow  # file-level wall clock > 60 s

VALUE_DT = Date(1, 1, 2024)
TENORS = ["1M", "6M", "1Y", "2Y", "3Y", "5Y", "7Y", "10Y", "20Y", "30Y"]
RATES = [5.19, 5.04, 4.71, 4.35, 4.13, 3.93, 3.87, 3.87, 3.88, 3.71]


@pytest.fixture(scope="module")
def model():
    m = Model(VALUE_DT)
    m.build_curve("GBP_OIS_SONIA", px_list=RATES, tenor_list=TENORS,
                  fixed_dcc_type=DayCountTypes.ACT_365F,
                  float_dc_type=DayCountTypes.ACT_365F)
    return m


@pytest.fixture(scope="module")
def swaps():
    rng = np.random.default_rng(42)
    out = []
    for ten in ["2Y", "5Y", "7Y", "10Y", "20Y"]:
        for _ in range(4):
            out.append(OIS(
                VALUE_DT, ten,
                SwapTypes.PAY if rng.random() < 0.5 else SwapTypes.RECEIVE,
                float(rng.uniform(0.02, 0.05)), FrequencyTypes.ANNUAL,
                DayCountTypes.ACT_365F, CurveTypes.GBP_OIS_SONIA,
                CurrencyTypes.GBP,
                notional=float(rng.uniform(1e6, 1e7)),
                float_dc_type=DayCountTypes.ACT_365F,
                bd_type=BusDayAdjustTypes.MODIFIED_FOLLOWING))
    return out


@pytest.fixture(scope="module")
def book(swaps):
    return compile_book(swaps, VALUE_DT)


class TestBookPVs:
    def test_matches_per_trade_valuation(self, model, swaps, book):
        curve = model.curves.GBP_OIS_SONIA
        fn = make_book_fn(curve._plan, curve._interp_type, want_gamma=False)
        out = fn(jnp.asarray(curve.swap_rates), book, aggregate_book(book),
                 jnp.zeros((1, len(RATES))))
        pvs = np.array(out["pvs"][0])
        direct = np.array([s.value(VALUE_DT, curve, None) for s in swaps])
        np.testing.assert_allclose(pvs, direct, rtol=1e-10, atol=1e-6)

    def test_book_delta_matches_engine_sum(self, model, swaps, book):
        curve = model.curves.GBP_OIS_SONIA
        fn = make_book_fn(curve._plan, curve._interp_type, want_gamma=True)
        out = fn(jnp.asarray(curve.swap_rates), book, aggregate_book(book),
                 jnp.zeros((1, len(RATES))))
        book_delta = np.array(out["delta"][0]) * 1e-4
        engine_sum = np.zeros(len(RATES))
        for s in swaps:
            res = s.position(model).compute([RequestTypes.DELTA])
            engine_sum += res.risk.risk_ladder
        np.testing.assert_allclose(book_delta, engine_sum, rtol=1e-8,
                                   atol=1e-8)

    def test_scenario_axis(self, model, book):
        curve = model.curves.GBP_OIS_SONIA
        fn = make_book_fn(curve._plan, curve._interp_type, want_gamma=False)
        shocks = jnp.array([[0.0] * len(RATES),
                            [1e-4] * len(RATES),
                            [-1e-4] * len(RATES)])
        out = fn(jnp.asarray(curve.swap_rates), book, aggregate_book(book), shocks)
        pvs = np.array(out["pvs"])
        assert pvs.shape[0] == 3
        # FD from the scenario axis should match the AD delta
        fd = (np.sum(pvs[1]) - np.sum(pvs[2])) / 2
        ad = float(np.sum(out["delta"][0])) * 1e-4
        assert fd == pytest.approx(ad, rel=1e-5)

    def test_tile_book(self, model, book):
        curve = model.curves.GBP_OIS_SONIA
        tiled = tile_book(book, 5)
        assert tiled.num_trades == 5 * book.num_trades
        fn = make_book_fn(curve._plan, curve._interp_type, want_gamma=False)
        out = fn(jnp.asarray(curve.swap_rates), tiled, aggregate_book(tiled),
                 jnp.zeros((1, len(RATES))))
        pvs = np.array(out["pvs"][0]).reshape(5, book.num_trades)
        np.testing.assert_allclose(pvs, np.tile(pvs[0], (5, 1)))


class TestMeshSharding:
    def test_sharded_equals_single_device(self, model, book):
        devices = jax.devices()
        if len(devices) < 2:
            pytest.skip("needs multiple devices")
        curve = model.curves.GBP_OIS_SONIA
        n_dev = 4 if len(devices) >= 4 else 2
        mesh = Mesh(np.array(devices[:n_dev]), ("book",))
        # pad trades to a multiple of the mesh size
        tiled = tile_book(book, n_dev)

        plain = make_book_fn(curve._plan, curve._interp_type)
        sharded = make_sharded_book_fn(curve._plan, curve._interp_type,
                                       mesh)
        rates = jnp.asarray(curve.swap_rates)
        shocks = jnp.array([[0.0] * len(RATES), [5e-4] * len(RATES)])

        ref = plain(rates, tiled, aggregate_book(tiled), shocks)
        book_sh = shard_book(tiled, mesh)
        out = sharded(rates, book_sh, shocks)

        np.testing.assert_allclose(np.array(out["total_pv"]),
                                   np.sum(np.array(ref["pvs"]), axis=1),
                                   rtol=1e-12)
        np.testing.assert_allclose(np.array(out["delta"]),
                                   np.array(ref["delta"]), rtol=1e-10)
        np.testing.assert_allclose(np.array(out["gamma"]),
                                   np.array(ref["gamma"]), rtol=1e-8,
                                   atol=1e-10)

    def test_gamma_symmetry_sharded(self, model, book):
        devices = jax.devices()
        if len(devices) < 2:
            pytest.skip("needs multiple devices")
        curve = model.curves.GBP_OIS_SONIA
        mesh = Mesh(np.array(devices[:2]), ("book",))
        tiled = tile_book(book, 2)
        fn = make_sharded_book_fn(curve._plan, curve._interp_type, mesh)
        out = fn(jnp.asarray(curve.swap_rates), shard_book(tiled, mesh),
                 jnp.zeros((1, len(RATES))))
        g = np.array(out["gamma"][0])
        np.testing.assert_allclose(g, g.T, rtol=1e-10, atol=1e-12)


class TestBucketedBooks:
    """Pad-size bucketed compilation must price identically to the
    monolithic book (same unique grid, same kernels), and the merged
    aggregate must reproduce the total PV / delta / gamma."""

    def test_bucketed_pvs_match_monolithic(self, model, swaps, book):
        from adrates_tpu.parallel import (book_pvs, compile_book_buckets,
                                          make_bucketed_book_fn,
                                          merge_aggregates)
        curve = model.curves.GBP_OIS_SONIA
        books, order = compile_book_buckets(swaps, VALUE_DT, n_buckets=3)
        assert sum(b.num_trades for b in books) == len(swaps)
        pads = [b.fix_idx.shape[1] for b in books]
        assert pads == sorted(pads)

        agg = merge_aggregates([aggregate_book(b) for b in books])
        fn = make_bucketed_book_fn(curve._plan, curve._interp_type)
        rates = jnp.asarray(curve.swap_rates)
        shocks = jnp.zeros((2, rates.shape[0])).at[1].set(1e-4)
        out = fn(rates, books, agg, shocks)

        mono = np.asarray(book_pvs(rates, curve._plan, curve._interp_type,
                                   book))
        bucketed = np.asarray(out["pvs"][0])
        assert np.allclose(bucketed, mono[np.asarray(order)],
                           rtol=0, atol=1e-6)

        # merged aggregate total == sum of per-trade PVs
        total = float(np.sum(mono))
        from adrates_tpu.parallel import aggregate_total_pv
        agg_total = float(aggregate_total_pv(rates, curve._plan,
                                             curve._interp_type, agg))
        assert agg_total == pytest.approx(total, abs=1e-6)
        assert np.all(np.isfinite(np.asarray(out["delta"])))
        assert np.all(np.isfinite(np.asarray(out["gamma"])))
