"""Model.build_parallel: thread-pool curve builds must be bit-identical
to the sequential build, and exceptions must propagate (the claimed
dict-insert/tracing safety gets a direct test)."""

import numpy as np
import pytest

from adrates_tpu.models import Model
from adrates_tpu.utils import Date, DayCountTypes, InterpTypes

TENORS = ["3M", "6M", "1Y", "2Y", "3Y", "5Y", "7Y", "10Y"]
GBP_RATES = [5.15, 5.04, 4.71, 4.35, 4.13, 3.93, 3.87, 3.87]
USD_RATES = [r + 0.35 for r in GBP_RATES]
XCCY_TENORS = ["1Y", "2Y", "5Y", "10Y"]
BASIS = [-8.0, -7.5, -7.0, -6.5]


def _ois_kwargs(rates):
    return dict(px_list=rates, tenor_list=TENORS,
                fixed_dcc_type=DayCountTypes.ACT_365F,
                float_dc_type=DayCountTypes.ACT_365F,
                interp_type=InterpTypes.FLAT_FWD_RATES)


def _build(parallel):
    m = Model(Date(1, 1, 2024))
    if parallel:
        # wave 1: independent OIS builds concurrently; wave 2 reads them
        m.build_parallel(
            [lambda: m.build_curve("GBP_OIS_SONIA",
                                   **_ois_kwargs(GBP_RATES)),
             lambda: m.build_curve("USD_OIS_SOFR",
                                   **_ois_kwargs(USD_RATES))],
            [lambda: m.build_xccy_curve(
                name="GBP_USD_XCCY",
                domestic_curve_name="USD_OIS_SOFR",
                foreign_curve_name="GBP_OIS_SONIA",
                basis_spreads=BASIS, tenor_list=XCCY_TENORS,
                spot_fx=1.27)])
    else:
        m.build_curve("GBP_OIS_SONIA", **_ois_kwargs(GBP_RATES))
        m.build_curve("USD_OIS_SOFR", **_ois_kwargs(USD_RATES))
        m.build_xccy_curve(name="GBP_USD_XCCY",
                           domestic_curve_name="USD_OIS_SOFR",
                           foreign_curve_name="GBP_OIS_SONIA",
                           basis_spreads=BASIS, tenor_list=XCCY_TENORS,
                           spot_fx=1.27)
    return m


class TestBuildParallel:
    def test_two_wave_build_bit_identical_to_sequential(self):
        seq = _build(parallel=False)
        par = _build(parallel=True)
        assert set(par._curves_dict) == set(seq._curves_dict)
        for name in seq._curves_dict:
            cs, cp = seq.curves[name], par.curves[name]
            np.testing.assert_array_equal(np.asarray(cs._times),
                                          np.asarray(cp._times))
            np.testing.assert_array_equal(np.asarray(cs._dfs),
                                          np.asarray(cp._dfs))
        # stored rebuild params identical too (scenario() must behave
        # the same on either model)
        assert (sorted(seq._curve_params_dict)
                == sorted(par._curve_params_dict))

    def test_exceptions_propagate(self):
        m = Model(Date(1, 1, 2024))

        def boom():
            raise RuntimeError("wave failure")

        with pytest.raises(RuntimeError, match="wave failure"):
            m.build_parallel(
                [lambda: m.build_curve("GBP_OIS_SONIA",
                                       **_ois_kwargs(GBP_RATES)),
                 boom])
        # the successful sibling build still landed
        assert "GBP_OIS_SONIA" in m._curves_dict

    def test_empty_and_single_waves(self):
        m = Model(Date(1, 1, 2024))
        m.build_parallel(
            [],
            [lambda: m.build_curve("GBP_OIS_SONIA",
                                   **_ois_kwargs(GBP_RATES))])
        assert "GBP_OIS_SONIA" in m._curves_dict

    def test_basket_layout_independent_of_insertion_order(self):
        """Thread-completion order must not leak into the compiled book
        layout: two models with the SAME curves inserted in different
        orders must produce identical quote packing and grid compaction
        (the shipped-executables fingerprint depends on it — a
        build_parallel race made a fresh process compact one fewer grid
        pair than the exporter, BENCH_r05)."""
        from adrates_tpu.parallel import compile_multibook
        from adrates_tpu.trades.rates import OIS
        from adrates_tpu.utils import (CurrencyTypes, CurveTypes,
                                       FrequencyTypes, SwapTypes)

        def build(order):
            m = Model(Date(1, 1, 2024))
            defs = {"GBP_OIS_SONIA": GBP_RATES,
                    "USD_OIS_SOFR": USD_RATES}
            for name in order:
                m.build_curve(name, **_ois_kwargs(defs[name]))
            m.build_fx(["GBPUSD"], [1.27])
            m.build_xccy_curve(name="GBP_USD_XCCY",
                               domestic_curve_name="USD_OIS_SOFR",
                               foreign_curve_name="GBP_OIS_SONIA",
                               basis_spreads=BASIS,
                               tenor_list=XCCY_TENORS, spot_fx=1.27)
            trades = [OIS(Date(1, 1, 2024), "5Y", SwapTypes.RECEIVE,
                          0.04, FrequencyTypes.ANNUAL,
                          DayCountTypes.ACT_365F,
                          CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP),
                      OIS(Date(1, 1, 2024), "3Y", SwapTypes.PAY, 0.045,
                          FrequencyTypes.ANNUAL, DayCountTypes.ACT_360,
                          CurveTypes.USD_OIS_SOFR, CurrencyTypes.USD)]
            return compile_multibook(trades, m,
                                     base_currency=CurrencyTypes.USD)

        a = build(["GBP_OIS_SONIA", "USD_OIS_SOFR"])
        b = build(["USD_OIS_SOFR", "GBP_OIS_SONIA"])
        assert [s.name for s in a.basket.specs] \
            == [s.name for s in b.basket.specs]
        assert a.basket.n_grid == b.basket.n_grid
        np.testing.assert_array_equal(a.basket.grid_sel,
                                      b.basket.grid_sel)
        np.testing.assert_array_equal(np.asarray(a.basket.quotes0),
                                      np.asarray(b.basket.quotes0))
