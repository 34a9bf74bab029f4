"""Math kernels and helpers.

Mirrors the reference's utils/math.py + helpers.py coverage: normal CDF /
inverse, bivariate normal, tridiagonal solve, NPV, tenor labels,
sensitivity conversion, format helpers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import stats

from adrates_tpu.utils import (Date, convert_sensitivities, format_table,
                               label_to_string, times_from_dates, to_tenor)
from adrates_tpu.utils.math import (N, accrued_interpolator, cholesky,
                                    norminvcdf, normpdf, npv, phi2,
                                    solve_tridiagonal)
from adrates_tpu.utils.math import test_monotonicity as is_monotonic
from adrates_tpu.utils.math import test_range as in_range


class TestNormal:
    def test_cdf_matches_scipy(self):
        x = np.linspace(-5, 5, 41)
        np.testing.assert_allclose(np.array(N(jnp.array(x))),
                                   stats.norm.cdf(x), atol=1e-12)

    def test_inverse_roundtrip(self):
        p = np.linspace(0.01, 0.99, 21)
        x = np.array(norminvcdf(jnp.array(p)))
        np.testing.assert_allclose(np.array(N(jnp.array(x))), p,
                                   atol=1e-10)

    def test_pdf(self):
        assert float(normpdf(0.0)) == pytest.approx(
            1 / np.sqrt(2 * np.pi), abs=1e-12)

    def test_bivariate_independent(self):
        # rho=0: phi2(a,b,0) = N(a)*N(b)
        v = float(phi2(0.5, -0.3, 0.0))
        expected = stats.norm.cdf(0.5) * stats.norm.cdf(-0.3)
        assert v == pytest.approx(expected, abs=1e-8)

    def test_bivariate_perfect_correlation(self):
        # rho->1: phi2(a,b,1) = N(min(a,b))
        v = float(phi2(0.5, -0.3, 0.999999))
        assert v == pytest.approx(stats.norm.cdf(-0.3), abs=1e-3)


class TestLinearAlgebra:
    def test_cholesky(self):
        a = np.array([[4.0, 2.0], [2.0, 3.0]])
        c = np.array(cholesky(jnp.array(a)))
        np.testing.assert_allclose(c @ c.T, a, atol=1e-12)

    def test_tridiagonal_vs_dense(self):
        rng = np.random.default_rng(3)
        n = 17
        lo = rng.normal(size=n)
        up = rng.normal(size=n)
        di = 5.0 + rng.random(n)
        rhs = rng.normal(size=n)
        A = np.diag(di) + np.diag(lo[1:], -1) + np.diag(up[:-1], 1)
        x = np.array(solve_tridiagonal(jnp.array(lo), jnp.array(di),
                                       jnp.array(up), jnp.array(rhs)))
        np.testing.assert_allclose(x, np.linalg.solve(A, rhs), atol=1e-12)


class TestFinancialMath:
    def test_npv(self):
        v = float(npv(jnp.array([1.0, 2.0]), jnp.array([100.0, 100.0]),
                      0.05))
        expected = 100 * np.exp(-0.05) + 100 * np.exp(-0.1)
        assert v == pytest.approx(expected, abs=1e-10)

    def test_accrued_interpolator(self):
        t = jnp.array([0.25])
        out = float(accrued_interpolator(t, jnp.array([0.0, 0.5, 1.0]),
                                         jnp.array([0.0, 10.0, 10.0]))[0])
        assert out == pytest.approx(5.0)

    def test_monotonicity(self):
        assert is_monotonic(jnp.array([1.0, 2.0, 3.0]))
        assert not is_monotonic(jnp.array([1.0, 3.0, 2.0]))

    def test_range(self):
        assert in_range(jnp.array([0.2, 0.8]), 0.0, 1.0)
        assert not in_range(jnp.array([-0.1]), 0.0, 1.0)


class TestTenorLabels:
    @pytest.mark.parametrize("val,expected", [
        (0.02, "2W"), (0.25, "3M"), (0.5, "6M"), (1.0, "1Y"),
        (1.5, "1Y6M"), (10.0, "10Y"), (10.02, "10Y"),
    ])
    def test_to_tenor(self, val, expected):
        assert to_tenor(val) == expected

    def test_list(self):
        assert to_tenor([0.25, 1.0]) == ["3M", "1Y"]


class TestTimesFromDates:
    def test_scalar(self):
        t = times_from_dates(Date(1, 1, 2025), Date(1, 1, 2024))
        assert t == pytest.approx(366 / 365)

    def test_vector(self):
        ts = times_from_dates([Date(1, 7, 2024), Date(1, 1, 2025)],
                              Date(1, 1, 2024))
        assert ts.shape == (2,)

    def test_with_day_count(self):
        from adrates_tpu.utils import DayCountTypes
        t = times_from_dates(Date(1, 1, 2025), Date(1, 1, 2024),
                             DayCountTypes.ACT_360)
        assert t == pytest.approx(366 / 360)


class TestSensitivityConversion:
    def test_df_to_zero_sens(self):
        times = np.array([1.0, 2.0])
        dfs = np.exp(-0.04 * times)
        df_sens = np.array([100.0, 200.0])
        out = convert_sensitivities(df_sens, times, dfs)
        np.testing.assert_allclose(out, df_sens * (-times) * dfs)


class TestFormatting:
    def test_label_to_string(self):
        s = label_to_string("LABEL", 42)
        assert "LABEL" in s and "42" in s

    def test_format_table(self):
        t = format_table(["A", "B"], [[1, 2], [3, 4]])
        assert "A" in t and "4" in t
        assert t.count("+") >= 4


class TestMathCompatSurface:
    """Module-level compat functions (reference math.py:105-800)."""

    def test_scale_maxaxis_minaxis(self):
        from adrates_tpu.utils.math import maxaxis, minaxis, scale
        np.testing.assert_allclose(scale([1.0, 2.0], 3.0), [3.0, 6.0])
        m = np.array([[1.0, 5.0], [4.0, 2.0]])
        np.testing.assert_allclose(maxaxis(m), [5.0, 4.0])
        np.testing.assert_allclose(minaxis(m), [1.0, 2.0])

    def test_covar(self):
        from adrates_tpu.utils.math import covar
        a = np.array([1.0, 2.0, 3.0, 4.0])
        b = np.array([2.0, 1.0, 4.0, 3.0])
        c = covar(a, b)
        np.testing.assert_allclose(c[0][0], np.var(a), atol=1e-12)
        np.testing.assert_allclose(c[1][1], np.var(b), atol=1e-12)
        np.testing.assert_allclose(
            c[0][1], np.mean(a * b) - a.mean() * b.mean(), atol=1e-12)
        assert c[0][1] == c[1][0]

    def test_pair_gcd(self):
        from adrates_tpu.utils.math import pair_gcd
        assert pair_gcd(12, 18) == 6
        assert pair_gcd(7, 13) == 1
        assert pair_gcd(0, 5) == 0

    def test_heaviside_nprime(self):
        from adrates_tpu.utils.math import heaviside, nprime
        np.testing.assert_allclose(heaviside([-1.0, 0.0, 2.0]),
                                   [0.0, 1.0, 1.0])
        assert float(nprime(0.0)) == pytest.approx(
            1 / np.sqrt(2 * np.pi), abs=1e-12)

    def test_frange(self):
        from adrates_tpu.utils.math import frange
        assert frange(0, 10, 2) == [0, 2, 4, 6, 8, 10]
        np.testing.assert_allclose(frange(0.0, 1.0, 0.25),
                                   [0.0, 0.25, 0.5, 0.75, 1.0])

    def test_normcdf_variants(self):
        from adrates_tpu.utils.math import (n_vect, normcdf_integrate,
                                            normcdf_slow)
        assert normcdf_slow(1.5) == pytest.approx(stats.norm.cdf(1.5),
                                                  abs=1e-14)
        assert normcdf_integrate(0.7) == pytest.approx(
            stats.norm.cdf(0.7), abs=1e-7)
        np.testing.assert_allclose(np.array(n_vect([0.0, 1.0])),
                                   stats.norm.cdf([0.0, 1.0]), atol=1e-12)

    def test_corr_matrix_generator(self):
        from adrates_tpu.utils.math import corr_matrix_generator
        c = corr_matrix_generator(0.3, 4)
        assert c.shape == (4, 4)
        np.testing.assert_allclose(np.diag(c), np.ones(4))
        assert np.all(c[~np.eye(4, dtype=bool)] == 0.3)
        assert np.all(np.linalg.eigvalsh(c) > 0)

    def test_band_matrix_multiplication(self):
        from adrates_tpu.utils.math import band_matrix_multiplication
        # tridiagonal as band storage m1=m2=1
        n = 5
        rng = np.random.default_rng(0)
        lo, di, up = rng.normal(size=n), rng.normal(size=n), \
            rng.normal(size=n)
        full = np.diag(di) + np.diag(lo[1:], -1) + np.diag(up[:-1], 1)
        band = np.stack([lo, di, up], axis=1)
        b = rng.normal(size=n)
        np.testing.assert_allclose(
            band_matrix_multiplication(band, 1, 1, b), full @ b,
            atol=1e-12)

    def test_solve_and_transpose_tridiagonal_matrix(self):
        from adrates_tpu.utils.math import (solve_tridiagonal_matrix,
                                            transpose_tridiagonal_matrix)
        n = 6
        rng = np.random.default_rng(1)
        lo = rng.normal(size=n) * 0.1
        di = 2.0 + rng.normal(size=n) * 0.1
        up = rng.normal(size=n) * 0.1
        lo[0] = up[-1] = 0.0
        A = np.stack([lo, di, up], axis=1)
        full = np.diag(di) + np.diag(lo[1:], -1) + np.diag(up[:-1], 1)
        r = rng.normal(size=n)
        np.testing.assert_allclose(solve_tridiagonal_matrix(A, r),
                                   np.linalg.solve(full, r), atol=1e-9)
        At = transpose_tridiagonal_matrix(A)
        np.testing.assert_allclose(solve_tridiagonal_matrix(At, r),
                                   np.linalg.solve(full.T, r), atol=1e-9)


class TestHelpersCompatSurface:
    """Module-level compat helpers (reference helpers.py:116-640)."""

    def test_beta_vector_to_corr_matrix(self):
        from adrates_tpu.utils.helpers import beta_vector_to_corr_matrix
        c = beta_vector_to_corr_matrix([0.5, 0.8, 0.3])
        np.testing.assert_allclose(np.diag(c), np.ones(3))
        assert c[0][1] == pytest.approx(0.4)
        assert c[1][2] == pytest.approx(0.24)

    def test_pv01_times(self):
        from adrates_tpu.utils.helpers import pv01_times
        out = pv01_times(2.0, 2.0)
        np.testing.assert_allclose(out, [2.0, 1.5, 1.0, 0.5, 0.0])

    def test_listdiff_dotproduct_normalise(self):
        from adrates_tpu.utils.helpers import (dotproduct, listdiff,
                                               normalise_weights)
        np.testing.assert_allclose(listdiff([3.0, 5.0], [1.0, 2.0]),
                                   [2.0, 3.0])
        assert dotproduct([1.0, 2.0], [3.0, 4.0]) == pytest.approx(11.0)
        np.testing.assert_allclose(normalise_weights([2.0, 6.0]),
                                   [0.25, 0.75])

    def test_check_dt(self):
        from adrates_tpu.utils.error import LibError
        from adrates_tpu.utils.helpers import check_dt
        check_dt(Date(1, 1, 2024))
        with pytest.raises(LibError):
            check_dt("2024-01-01")

    def test_to_usable_type(self):
        from typing import List, Union
        from adrates_tpu.utils.helpers import to_usable_type
        assert isinstance([1.0], to_usable_type(List[float]))
        assert isinstance(np.array([1.0]), to_usable_type(List[float]))
        assert isinstance(3.5, to_usable_type(float))
        assert isinstance(3, to_usable_type(Union[int, float]))

    def test_accrued_tree(self):
        from adrates_tpu.utils.helpers import accrued_tree
        grid_t = np.array([0.0, 0.25, 0.5, 0.75, 1.0])
        flows = np.array([0.0, 0.0, 0.05, 0.0, 0.05])
        acc = accrued_tree(grid_t, flows, 100.0)
        # between coupons at 0.5 and 1.0, accrual is linear in t
        assert acc[3] == pytest.approx(100.0 * 0.25 * 0.05 / 0.5)
        # at a coupon time the full accrual of that period
        assert acc[4] == pytest.approx(100.0 * 0.5 * 0.05 / 0.5)


class TestDateCompatSurface:
    """Module-level date compat functions (reference date.py:123-1110)."""

    def test_parse_dt_and_from_datetime(self):
        import datetime
        from adrates_tpu.utils.date import from_datetime, parse_dt
        assert parse_dt("2024-03-15", "%Y-%m-%d") == (15, 3, 2024)
        d = from_datetime(datetime.date(2024, 3, 15))
        assert (d.d(), d.m(), d.y()) == (15, 3, 2024)

    def test_weekday_serial_convention(self):
        from adrates_tpu.utils.date import weekday
        d = Date(15, 3, 2024)  # a Friday
        assert weekday(d.serial()) == (d.serial() + 5) % 7

    def test_date_index_roundtrip(self):
        from adrates_tpu.utils.date import date_from_index, date_index
        for dmy in [(1, 1, 1900), (15, 3, 2024), (31, 12, 2100)]:
            assert date_from_index(date_index(*dmy)) == dmy

    def test_daily_working_day_schedule(self):
        from adrates_tpu.utils.date import daily_working_day_schedule
        out = daily_working_day_schedule(Date(1, 3, 2024), Date(8, 3, 2024))
        # Fri 1st included, then Mon..Fri of next week
        assert out[0] == Date(1, 3, 2024)
        assert out[-1] == Date(8, 3, 2024)
        assert all(not d.is_weekend() for d in out)
        assert len(out) == 6


class TestCalendarCompatSurface:
    def test_per_region_holiday_methods(self):
        from adrates_tpu.utils.calendar import Calendar, CalendarTypes
        cal = Calendar(CalendarTypes.WEEKEND)
        # Christmas 2024 is a Wednesday: a holiday in every region
        xmas = Date(25, 12, 2024)
        assert cal.holiday_united_kingdom(xmas)
        assert cal.holiday_united_states(xmas)
        assert cal.holiday_target(xmas)
        assert cal.holiday_japan(Date(1, 1, 2024))
        assert not cal.holiday_none(xmas)
        assert cal.holiday_weekend(Date(7, 12, 2024))  # a Saturday
        # a plain business day is no holiday anywhere checked
        biz = Date(4, 6, 2024)  # a Tuesday
        assert not cal.holiday_united_kingdom(biz)
        assert not cal.holiday_switzerland(biz)


class TestModuleConstantParity:
    def test_math_constants(self):
        from adrates_tpu.utils.math import (ONE_BILLION, ONE_MILLION,
                                            TEN_MILLION, inv_root_two_pi)
        assert inv_root_two_pi == pytest.approx(1 / np.sqrt(2 * np.pi),
                                                abs=1e-15)
        assert (ONE_MILLION, TEN_MILLION, ONE_BILLION) == \
            (10**6, 10**7, 10**9)

    def test_currency_ron(self):
        from adrates_tpu.utils.currency import CurrencyTypes
        assert CurrencyTypes.RON.name == "RON"

    def test_easter_monday_table(self):
        from adrates_tpu.utils.calendar import (easterMondayDay,
                                                easter_monday_day_of_year)
        # reference calendar.py:51-100 convention: index y - 1901
        assert easterMondayDay[2024 - 1901] == \
            easter_monday_day_of_year(2024)
        # 1 Apr 2024 is Easter Monday: day-of-year 92 (leap year)
        assert easterMondayDay[2024 - 1901] == 92
        # 299 entries = 1901..2199 inclusive, matching the reference
        # list's length exactly
        assert len(easterMondayDay) == 299
        assert len(list(easterMondayDay)) == 299
        assert easterMondayDay[:3] == [98, 90, 103]  # 1901-1903
        assert easterMondayDay[-1] == easterMondayDay[298]  # 2199
        with pytest.raises(IndexError):
            easterMondayDay[299]

    def test_calculate_list_excel_serials(self):
        import adrates_tpu.utils.date as dmod
        from adrates_tpu.utils.date import Date, date_index
        dmod.calculate_list()
        tbl = dmod.g_dt_counter_list
        # Lotus bug: 1 Mar 1900 has serial 61 (phantom 29 Feb counted)
        assert tbl[date_index(1, 3, 1900)] == 61
        assert tbl[date_index(15, 3, 2024)] == Date(15, 3, 2024).serial()
        assert tbl[date_index(31, 2, 2024)] == -999

    def test_date_test_type_prints(self, capsys):
        from adrates_tpu.utils.date import test_type
        test_type()
        assert "TEST TYPE" in capsys.readouterr().out

    def test_long_month_names(self):
        from adrates_tpu.utils.date import longMonthNames
        assert longMonthNames[0] == "JANUARY" and len(longMonthNames) == 12
