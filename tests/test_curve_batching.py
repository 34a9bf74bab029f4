"""Batched curve graph (parallel/curve_batching.py) parity vs the
per-curve legacy graph: values AND first/second derivatives must agree
— batching changes only the compile-time structure, never the math.

The batched graph exists because the compile time of the risk programs
grows with HLO op count; grouping same-topology curves into vmapped
bootstraps cut the curve graph ~3x (see the module docstring).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adrates_tpu.models import Model
from adrates_tpu.parallel.multibook import CurveBasket
from adrates_tpu.utils import (Date, DayCountTypes, InterpTypes)

pytestmark = pytest.mark.slow  # file-level wall clock > 60 s

VALUE_DT = Date(1, 1, 2024)


@pytest.fixture(scope="module")
def model():
    """Heterogeneous basket: mixed pillar counts (padding inside a
    group), two XCCY curves sharing a domestic curve, two inflation
    curves with different pillar counts."""
    m = Model(VALUE_DT)
    m.build_curve("USD_OIS_SOFR", px_list=[5.3, 5.0, 4.6, 4.0, 3.88, 3.8],
                  tenor_list=["6M", "1Y", "2Y", "5Y", "10Y", "20Y"],
                  fixed_dcc_type=DayCountTypes.ACT_360,
                  float_dc_type=DayCountTypes.ACT_360,
                  interp_type=InterpTypes.FLAT_FWD_RATES)
    m.build_curve("GBP_OIS_SONIA", px_list=[5.0, 4.7, 4.3, 3.9],
                  tenor_list=["1Y", "2Y", "5Y", "10Y"],
                  fixed_dcc_type=DayCountTypes.ACT_365F,
                  float_dc_type=DayCountTypes.ACT_365F,
                  interp_type=InterpTypes.FLAT_FWD_RATES)
    m.build_curve("EUR_OIS_ESTR", px_list=[3.8, 3.5, 3.1, 2.9, 2.88],
                  tenor_list=["6M", "1Y", "2Y", "5Y", "10Y"],
                  fixed_dcc_type=DayCountTypes.ACT_360,
                  float_dc_type=DayCountTypes.ACT_360,
                  interp_type=InterpTypes.FLAT_FWD_RATES)
    m.build_fx(["GBPUSD", "EURUSD"], [1.27, 1.09])
    m.build_xccy_curve(name="GBP_USD_XCCY",
                       domestic_curve_name="USD_OIS_SOFR",
                       foreign_curve_name="GBP_OIS_SONIA",
                       basis_spreads=[-5.0, -8.0, -11.0],
                       tenor_list=["1Y", "5Y", "10Y"], spot_fx=1.27)
    m.build_xccy_curve(name="EUR_USD_XCCY",
                       domestic_curve_name="USD_OIS_SOFR",
                       foreign_curve_name="EUR_OIS_ESTR",
                       basis_spreads=[-15.0, -18.0, -21.0],
                       tenor_list=["1Y", "5Y", "10Y"], spot_fx=1.09)
    m.build_inflation_curve(
        "GBP_RPI_INFLATION", base_cpi=293.0,
        breakeven_list=[3.9, 3.6, 3.5, 3.45],
        tenor_list=["1Y", "2Y", "5Y", "10Y"])
    m.build_inflation_curve(
        "USD_CPI_INFLATION", base_cpi=308.0,
        breakeven_list=[2.6, 2.4, 2.35],
        tenor_list=["1Y", "5Y", "10Y"])
    return m


UT = np.unique(np.concatenate([
    [0.0],
    np.sort(np.random.default_rng(0).uniform(0.01, 25.0, 160)),
    np.linspace(0.5, 10.0, 20),          # hits pillar-ish times
]))


def _pair(model, **kw):
    b_leg = CurveBasket(model, **kw)
    b_bat = CurveBasket(model, **kw)
    g_leg = b_leg.grids_fn(UT, batch_curves=False)
    g_bat = b_bat.grids_fn(UT, batch_curves=True)
    q0 = jnp.asarray(b_leg.quotes0)
    return (lambda q: g_leg(q, b_leg.params)), \
        (lambda q: g_bat(q, b_bat.params)), q0


class TestBatchedGridsParity:
    def test_values_identical(self, model):
        f_leg, f_bat, q0 = _pair(model)
        r1 = np.asarray(jax.jit(f_leg)(q0))
        r2 = np.asarray(jax.jit(f_bat)(q0))
        np.testing.assert_allclose(r2, r1, rtol=1e-13, atol=0.0)

    def test_values_identical_no_recalibration(self, model):
        f_leg, f_bat, q0 = _pair(model, recalibrate_xccy=False)
        r1 = np.asarray(jax.jit(f_leg)(q0))
        r2 = np.asarray(jax.jit(f_bat)(q0))
        np.testing.assert_allclose(r2, r1, rtol=1e-13, atol=0.0)

    def test_coarse_buckets_identical(self):
        """stage_buckets='coarse' merges mixed-pillar OIS curves into
        one padded stage (here 10-pillar + 4-pillar, which FINE buckets
        keep apart); values, jacobian and a term2-shaped hessian
        contraction must match the fine-bucket graph to f64 noise (the
        merge changes only padding, never the math)."""
        m = Model(VALUE_DT)
        m.build_curve(
            "GBP_OIS_SONIA",
            px_list=[5.2, 5.1, 5.0, 4.8, 4.7, 4.5, 4.3, 4.1, 3.9, 3.8],
            tenor_list=["3M", "6M", "9M", "1Y", "18M", "2Y", "3Y",
                        "5Y", "10Y", "20Y"],
            fixed_dcc_type=DayCountTypes.ACT_365F,
            float_dc_type=DayCountTypes.ACT_365F,
            interp_type=InterpTypes.FLAT_FWD_RATES)
        m.build_curve("USD_OIS_SOFR", px_list=[5.3, 4.9, 4.3, 4.0],
                      tenor_list=["1Y", "2Y", "5Y", "10Y"],
                      fixed_dcc_type=DayCountTypes.ACT_360,
                      float_dc_type=DayCountTypes.ACT_360,
                      interp_type=InterpTypes.FLAT_FWD_RATES)
        b_fine = CurveBasket(m)
        b_coarse = CurveBasket(m)
        g_f = b_fine.grids_fn(UT, batch_curves=True)
        g_c = b_coarse.grids_fn(UT, batch_curves=True,
                                stage_buckets="coarse")
        assert len(b_coarse._stages) < len(b_fine._stages)
        q0 = jnp.asarray(b_fine.quotes0)
        f = jax.jit(lambda q: g_f(q, b_fine.params))
        c = jax.jit(lambda q: g_c(q, b_coarse.params))
        r1, r2 = np.asarray(f(q0)), np.asarray(c(q0))
        np.testing.assert_allclose(r2, r1, rtol=1e-13, atol=0.0)
        J1 = np.asarray(jax.jit(jax.jacfwd(
            lambda q: g_f(q, b_fine.params)))(q0))
        J2 = np.asarray(jax.jit(jax.jacfwd(
            lambda q: g_c(q, b_coarse.params)))(q0))
        np.testing.assert_allclose(J2, J1, rtol=1e-12,
                                   atol=1e-14 * np.abs(J1).max())
        g0 = jnp.asarray(
            np.random.default_rng(2).normal(size=r1.shape))
        H1 = np.asarray(jax.jit(jax.jacfwd(jax.grad(
            lambda q: jnp.dot(g0, g_f(q, b_fine.params)))))(q0))
        H2 = np.asarray(jax.jit(jax.jacfwd(jax.grad(
            lambda q: jnp.dot(g0, g_c(q, b_coarse.params)))))(q0))
        np.testing.assert_allclose(H2, H1, rtol=1e-11,
                                   atol=1e-13 * np.abs(H1).max())

    def test_jacobian_identical(self, model):
        f_leg, f_bat, q0 = _pair(model)
        J1 = np.asarray(jax.jit(jax.jacfwd(f_leg))(q0))
        J2 = np.asarray(jax.jit(jax.jacfwd(f_bat))(q0))
        scale = np.abs(J1).max()
        np.testing.assert_allclose(J2, J1, rtol=1e-12,
                                   atol=1e-14 * scale)

    def test_hessian_contraction_identical(self, model):
        """term2-shaped second derivative (what the closed-form gamma
        uses) through both graphs."""
        f_leg, f_bat, q0 = _pair(model)
        g0 = jnp.asarray(
            np.random.default_rng(1).normal(size=f_leg(q0).shape))

        def h(f):
            return jax.jit(jax.jacfwd(jax.grad(
                lambda q: jnp.dot(g0, f(q)))))(q0)

        H1 = np.asarray(h(f_leg))
        H2 = np.asarray(h(f_bat))
        scale = np.abs(H1).max()
        np.testing.assert_allclose(H2, H1, rtol=1e-11,
                                   atol=1e-13 * scale)

    def test_shocked_quotes_identical(self, model):
        f_leg, f_bat, q0 = _pair(model)
        shock = jnp.asarray(
            np.random.default_rng(2).normal(0, 1e-3, q0.shape))
        r1 = np.asarray(jax.jit(f_leg)(q0 + shock))
        r2 = np.asarray(jax.jit(f_bat)(q0 + shock))
        np.testing.assert_allclose(r2, r1, rtol=1e-13, atol=0.0)


class TestNonSimpleSchemeFallback:
    def test_pchip_curve_falls_back_per_curve(self):
        m = Model(VALUE_DT)
        m.build_curve("GBP_OIS_SONIA", px_list=[5.0, 4.7, 4.3, 3.9],
                      tenor_list=["1Y", "2Y", "5Y", "10Y"],
                      fixed_dcc_type=DayCountTypes.ACT_365F,
                      float_dc_type=DayCountTypes.ACT_365F,
                      interp_type=InterpTypes.PCHIP_LOG_DISCOUNT)
        m.build_curve("USD_OIS_SOFR", px_list=[5.3, 5.0, 4.6, 4.0],
                      tenor_list=["1Y", "2Y", "5Y", "10Y"],
                      fixed_dcc_type=DayCountTypes.ACT_360,
                      float_dc_type=DayCountTypes.ACT_360,
                      interp_type=InterpTypes.FLAT_FWD_RATES)
        f_leg, f_bat, q0 = _pair(m)
        r1 = np.asarray(jax.jit(f_leg)(q0))
        r2 = np.asarray(jax.jit(f_bat)(q0))
        np.testing.assert_allclose(r2, r1, rtol=1e-13, atol=0.0)
