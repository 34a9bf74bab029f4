"""Structured logging/metrics + device policy + tile guards.

SURVEY §5 named metrics/observability an obligation of this build; these
tests pin the instrumentation contract (events recorded with counts and
durations) and the guard rails added in round 2.
"""

import logging

import numpy as np
import pytest

from adrates_tpu.models import Model
from adrates_tpu.utils import (CurrencyTypes, CurveTypes, Date,
                               DayCountTypes, FrequencyTypes,
                               RequestTypes, SwapTypes)
from adrates_tpu.utils.observability import configure, logger, metrics, timed
from adrates_tpu.trades.rates import OIS

VALUE_DT = Date(1, 1, 2024)


def _small_model():
    m = Model(VALUE_DT)
    m.build_curve("GBP_OIS_SONIA", px_list=[5.0, 4.5, 4.0],
                  tenor_list=["1Y", "2Y", "5Y"],
                  fixed_dcc_type=DayCountTypes.ACT_365F,
                  float_dc_type=DayCountTypes.ACT_365F)
    return m


class TestMetrics:
    def test_curve_build_recorded(self):
        metrics.reset()
        _small_model()
        snap = metrics.snapshot()
        assert snap["curve.build.ois"]["count"] == 1
        assert snap["curve.build.ois"]["total_seconds"] > 0
        assert snap["curve.refit.ois"]["count"] == 1

    def test_engine_compute_recorded(self):
        m = _small_model()
        swap = OIS(VALUE_DT, "5Y", SwapTypes.RECEIVE, 0.04,
                   FrequencyTypes.ANNUAL, DayCountTypes.ACT_365F,
                   CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP)
        metrics.reset()
        swap.position(m).compute([RequestTypes.VALUE])
        assert metrics.count("engine.compute") == 1

    def test_timed_accumulates(self):
        metrics.reset()
        with timed("unit.test.event", foo=1):
            pass
        with timed("unit.test.event"):
            pass
        snap = metrics.snapshot()["unit.test.event"]
        assert snap["count"] == 2

    def test_configure_emits_debug_records(self, caplog):
        configure(logging.DEBUG)
        try:
            with caplog.at_level(logging.DEBUG, logger="adrates_tpu"):
                with timed("unit.test.logline", pillars=3):
                    pass
            assert any("unit.test.logline" in r.message
                       or "unit.test.logline" in r.getMessage()
                       for r in caplog.records)
        finally:
            for h in list(logger.handlers):
                logger.removeHandler(h)


class TestDevicePolicy:
    def test_host_device_none_on_cpu_backend(self):
        """Tests run with the CPU as the default backend, so there is
        nothing to route: the contexts must be no-ops."""
        import jax

        from adrates_tpu.utils.device_policy import (host_device,
                                                     on_build_device)
        if jax.default_backend() == "cpu":
            assert host_device() is None
        with on_build_device():
            assert float(jax.numpy.asarray(1.0)) == 1.0


class TestTileGuards:
    def test_double_lazy_tile_rejected(self):
        from adrates_tpu.parallel import compile_multibook, tile_multibook
        from adrates_tpu.utils.error import LibError

        m = _small_model()
        swap = OIS(VALUE_DT, "5Y", SwapTypes.RECEIVE, 0.04,
                   FrequencyTypes.ANNUAL, DayCountTypes.ACT_365F,
                   CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP)
        mb = compile_multibook([swap], m,
                               base_currency=CurrencyTypes.GBP)
        lazy = tile_multibook(mb, 2)
        with pytest.raises(LibError):
            tile_multibook(lazy, 2)

    def test_sharded_path_requires_materialized(self):
        import jax
        from jax.sharding import Mesh

        from adrates_tpu.parallel import compile_multibook, tile_multibook
        from adrates_tpu.parallel.multibook import shard_multibook
        from adrates_tpu.utils.error import LibError

        m = _small_model()
        swap = OIS(VALUE_DT, "5Y", SwapTypes.RECEIVE, 0.04,
                   FrequencyTypes.ANNUAL, DayCountTypes.ACT_365F,
                   CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP)
        mb = compile_multibook([swap], m,
                               base_currency=CurrencyTypes.GBP)
        lazy = tile_multibook(mb, len(jax.devices()))
        mesh = Mesh(np.array(jax.devices()), ("book",))
        with pytest.raises(LibError):
            shard_multibook(lazy, mesh)
