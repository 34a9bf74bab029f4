"""Discount curve: (times, dfs) grid + interpolation + rate queries.

Behavioral parity with /root/reference/cavour/market/curves/discount_curve.py
(constructor 40-93, zero_rate 186-211, swap_rate 226-296, df 300-313,
fwd 452-477, bump 497-517, fwd_rate 520-562), with one deliberate
unification: all DF queries go through the single differentiable
interpolation stack (ops/interpolation.py) instead of a separate legacy
numpy path, so direct and engine valuations agree exactly.
"""

from __future__ import annotations

from typing import List, Union

import jax.numpy as jnp
import numpy as np

from ...ops.interpolation import (interp_df, interp_df_query,
                                  interp_fit)
from ...utils.date import Date
from ...utils.day_count import DayCount, DayCountTypes
from ...utils.error import LibError
from ...utils.frequency import FrequencyTypes, annual_frequency
from ...utils.global_types import InterpTypes
from ...utils.global_vars import gDaysInYear, gSmall
from ...utils.helpers import label_to_string, times_from_dates
from ...utils.schedule import Schedule


class DiscountCurve:
    """Base discount curve anchored at (t=0, df=1)."""

    def __init__(self,
                 value_dt: Date,
                 df_dts: list,
                 df_values: np.ndarray,
                 interp_type: InterpTypes = InterpTypes.FLAT_FWD_RATES):
        """Create a curve from year-fraction offsets (``df_dts``, in years
        from the value date as in the reference, which calls
        value_dt.add_years on them) and their discount factors."""
        if len(df_dts) < 1:
            raise LibError("Times has zero length")
        if len(df_dts) != len(df_values):
            raise LibError("Times and Values are not the same")

        times = [0.0]
        dfs = [1.0]
        df_dts_date = value_dt.add_years(list(df_dts))

        start_index = 0
        if len(df_dts) > 0 and df_dts_date[0] == value_dt:
            dfs[0] = float(df_values[0])
            start_index = 1

        for i in range(start_index, len(df_dts)):
            t = (df_dts_date[i] - value_dt) / gDaysInYear
            times.append(t)
            dfs.append(float(df_values[i]))

        self._times = jnp.array(times)
        self._dfs = jnp.array(dfs)
        self._df_dts = df_dts

        if not bool(jnp.all(self._times[1:] > self._times[:-1])):
            raise LibError("Times are not sorted in increasing order")

        self._value_dt = value_dt
        self._interp_type = interp_type
        self._freq_type = FrequencyTypes.CONTINUOUS
        self._dc_type = DayCountTypes.ACT_ACT_ISDA
        self._refresh_interpolator()

    # ------------------------------------------------------------------

    def _refresh_interpolator(self):
        """Recompute scheme aux state after _times/_dfs change."""
        self._interp_aux = interp_fit(self._times, self._dfs,
                                      self._interp_type)

    def value_dt(self) -> Date:
        return self._value_dt

    # ------------------------------------------------------------------
    # DF queries
    # ------------------------------------------------------------------

    def _df(self, t):
        """DF at time(s) t — unified interpolation stack, through the
        shape-bucketed module-level kernel (cold start: every distinct
        query length otherwise compiles its own tiny program)."""
        out = interp_df_query(jnp.asarray(t, dtype=jnp.float64),
                              self._times, self._dfs, self._interp_type,
                              self._interp_aux)
        return out

    def df(self, dt: Union[Date, list],
           day_count: DayCountTypes = DayCountTypes.ACT_ACT_ISDA):
        """DF at date(s); dates convert to times under ``day_count``.

        Host-side shaping in numpy: jnp.atleast_1d / device indexing
        here would be EAGER op dispatches (one compile per query
        shape)."""
        times = times_from_dates(dt, self._value_dt, day_count)
        dfs = self._df(np.atleast_1d(np.asarray(times,
                                                dtype=np.float64)))
        if isinstance(dt, Date):
            return float(np.asarray(dfs)[0])
        return np.array(dfs)

    def df_t(self, t):
        """DF at time(s) in years — jnp in/out, differentiable."""
        return self._df(t)

    def df_ad(self, t, day_count: DayCountTypes = DayCountTypes.ACT_ACT_ISDA):
        """AD-friendly DF from times (API parity: discount_curve.py:317)."""
        return self._df(t)

    def survival_prob(self, dt: Date):
        return self.df(dt)

    # ------------------------------------------------------------------
    # rate queries
    # ------------------------------------------------------------------

    def _zero_to_df(self, value_dt, rates, times,
                    freq_type: FrequencyTypes, dc_type: DayCountTypes):
        """Zero rate(s) -> DF(s) under a compounding frequency
        (discount_curve.py:102-133)."""
        t = np.maximum(np.atleast_1d(np.asarray(times, dtype=float)),
                       gSmall)
        rates = np.asarray(rates, dtype=float)
        f = annual_frequency(freq_type)
        if freq_type == FrequencyTypes.CONTINUOUS:
            df = np.exp(-rates * t)
        elif freq_type == FrequencyTypes.SIMPLE:
            df = 1.0 / (1.0 + rates * t)
        else:
            df = 1.0 / np.power(1.0 + rates / f, f * t)
        return df if df.size > 1 else float(df[0])

    def _df_to_zero(self, dfs, maturity_dts, freq_type: FrequencyTypes,
                    dc_type: DayCountTypes):
        f = annual_frequency(freq_type)
        date_list = [maturity_dts] if isinstance(maturity_dts, Date) \
            else maturity_dts
        df_arr = np.atleast_1d(np.asarray(dfs, dtype=float))
        times = np.atleast_1d(times_from_dates(date_list, self._value_dt,
                                               dc_type))
        t = np.maximum(times, gSmall)
        if freq_type == FrequencyTypes.CONTINUOUS:
            rates = -np.log(df_arr) / t
        elif freq_type == FrequencyTypes.SIMPLE:
            rates = (1.0 / df_arr - 1.0) / t
        else:
            rates = (np.power(df_arr, -1.0 / (t * f)) - 1.0) * f
        return rates

    def zero_rate(self, dts: Union[Date, list],
                  freq_type: FrequencyTypes = FrequencyTypes.CONTINUOUS,
                  dc_type: DayCountTypes = DayCountTypes.ACT_360):
        if isinstance(freq_type, FrequencyTypes) is False:
            raise LibError("Invalid Frequency type.")
        if isinstance(dc_type, DayCountTypes) is False:
            raise LibError("Invalid Day Count type.")
        dfs = self.df(dts)
        zero_rates = self._df_to_zero(dfs, dts, freq_type, dc_type)
        return zero_rates[0] if isinstance(dts, Date) else zero_rates

    def cc_rate(self, dts,
                dc_type: DayCountTypes = DayCountTypes.SIMPLE):
        return self.zero_rate(dts, FrequencyTypes.CONTINUOUS, dc_type)

    def swap_rate(self, effective_dt: Date, maturity_dt,
                  freq_type: FrequencyTypes = FrequencyTypes.ANNUAL,
                  dc_type: DayCountTypes = DayCountTypes.THIRTY_E_360):
        """Par swap rate(s) to maturity (unadjusted schedule), parity with
        discount_curve.py:226-296."""
        if effective_dt < self._value_dt:
            raise LibError("Swap starts before the curve valuation date.")
        if freq_type in (FrequencyTypes.SIMPLE, FrequencyTypes.CONTINUOUS):
            raise LibError("Cannot calculate par rate with this frequency.")

        single = isinstance(maturity_dt, Date)
        maturity_dts = [maturity_dt] if single else maturity_dt
        day_counter = DayCount(dc_type)
        par_rates = []
        for mat_dt in maturity_dts:
            if mat_dt <= effective_dt:
                raise LibError("Maturity date is before the swap start date.")
            flow_dts = Schedule(effective_dt, mat_dt, freq_type).generate()
            flow_dts[0] = effective_dt
            pv01 = 0.0
            df = 1.0
            prev_dt = flow_dts[0]
            for next_dt in flow_dts[1:]:
                df = self.df(next_dt)
                pv01 += day_counter.year_frac(prev_dt, next_dt)[0] * df
                prev_dt = next_dt
            if abs(pv01) < gSmall:
                par_rates.append(0.0)
            else:
                df_start = self.df(effective_dt)
                par_rates.append((df_start - df) / pv01)
        return par_rates[0] if single else np.array(par_rates)

    def fwd(self, dts):
        """Continuously compounded O/N forward rate at date(s)."""
        if isinstance(dts, Date):
            plus_one = [dts.add_days(1)]
            d_list = [dts]
        else:
            d_list = dts
            plus_one = [d.add_days(1) for d in dts]
        df1 = np.atleast_1d(self.df(d_list if len(d_list) > 1 or
                                    not isinstance(dts, Date) else dts))
        df2 = np.atleast_1d(self.df(plus_one))
        dt = 1.0 / gDaysInYear
        fwd = np.log(df1 / df2) / dt
        return float(fwd[0]) if isinstance(dts, Date) else np.array(fwd)

    def _fwd(self, times):
        """CC instantaneous forward by central difference in time space."""
        dt = 1e-6
        times = np.maximum(np.asarray(times, dtype=float), dt)
        df1 = np.array(self._df(jnp.atleast_1d(jnp.asarray(times - dt))))
        df2 = np.array(self._df(jnp.atleast_1d(jnp.asarray(times + dt))))
        out = np.log(df1 / df2) / (2.0 * dt)
        return out if out.size > 1 else float(out[0])

    def fwd_rate(self, start_dt, date_or_tenor,
                 dc_type: DayCountTypes = DayCountTypes.ACT_360):
        """Simple forward rate between two dates (or date+tenor)."""
        single = isinstance(start_dt, Date)
        start_dts = [start_dt] if single else start_dt
        day_count = DayCount(dc_type)
        fwd_rates = []
        for i, dt1 in enumerate(start_dts):
            if isinstance(date_or_tenor, str):
                dt2 = dt1.add_tenor(date_or_tenor)
            elif isinstance(date_or_tenor, Date):
                dt2 = date_or_tenor
            else:
                dt2 = date_or_tenor[i]
            year_frac = day_count.year_frac(dt1, dt2)[0]
            df1 = self.df(dt1)
            df2 = self.df(dt2)
            fwd_rates.append((df1 / df2 - 1.0) / year_frac)
        return fwd_rates[0] if single else np.array(fwd_rates)

    # ------------------------------------------------------------------

    def bump(self, bump_size: float) -> "DiscountCurve":
        """Parallel shift of continuous forwards: df_i *= exp(-s * t_i),
        returned as a new curve (discount_curve.py:497-517)."""
        new = self.__class__.__new__(self.__class__)
        new.__dict__.update(self.__dict__)
        new._dfs = self._dfs * jnp.exp(-bump_size * self._times)
        new._refresh_interpolator()
        return new

    # ------------------------------------------------------------------

    def __repr__(self):
        s = label_to_string("OBJECT TYPE", type(self).__name__)
        s += label_to_string("DATES", "DISCOUNT FACTORS")
        times = np.array(self._times)
        dfs = np.array(self._dfs)
        for t, df in zip(times, dfs):
            s += label_to_string(f"{t:12.8f}", f"{df:12.8f}")
        return s

    def _print(self):
        print(self)
