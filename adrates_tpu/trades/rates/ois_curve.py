"""OIS discount curve bootstrapped from par swap quotes.

Behavioral parity with /root/reference/cavour/trades/rates/ois_curve.py
(input prep 113-154, cashflow bootstrap 156-212, refit gate 344-358 at
SWAP_TOL=1e-10). The bootstrap itself lives in ops/bootstrap.py as a static
point plan + jitted lax.scan, shared by curve construction, the risk engine
and scenario vmaps — the reference maintains two divergent copies
(ois_curve.py recursion vs engine.py:2246-2360 scan).
"""

from __future__ import annotations

from functools import partial
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ...market.curves.discount_curve import DiscountCurve
from ...ops.bootstrap import OISBootstrapPlan, bootstrap_ois, \
    prepare_ois_plan
from ...ops.interpolation import interp_fit
from ...utils.date import Date
from ...utils.day_count import DayCount
from ...utils.error import LibError
from ...utils.frequency import FrequencyTypes
from ...utils.global_types import InterpTypes
from ...utils.helpers import label_to_string

SWAP_TOL = 1e-10

# module-level jits: one compile per TOPOLOGY (plan/book shapes), shared
# by every curve built in the process — a per-curve jax.jit(...) wrapper
# owns its own cache and recompiles identical programs (cold start)
from ...utils.compile_cache import build_jit  # noqa: E402

_bootstrap_ois_jit = build_jit(bootstrap_ois)


@build_jit(static_argnames=("interp_type",))
def _bootstrap_refit_jit(rates, plan, book, interp_type):
    """Bootstrap + refit-repricing in ONE program: the refit's internal
    re-bootstrap CSEs away inside XLA, so a checked curve build pays one
    compile instead of two (cold start)."""
    from ...parallel.book import book_pvs
    times, dfs = bootstrap_ois(rates, plan)
    return times, dfs, book_pvs(rates, plan, interp_type, book)


class OISCurve(DiscountCurve):
    """Discount curve implied by par OIS rates (solver-free cashflow
    bootstrap, differentiable end-to-end w.r.t. the quotes)."""

    def __init__(self,
                 value_dt: Date,
                 ois_swaps: list,
                 interp_type: InterpTypes = InterpTypes.FLAT_FWD_RATES,
                 check_refit: bool = False):
        from ...utils.observability import timed

        self._value_dt = value_dt
        self._used_swaps = ois_swaps
        self._interp_type = interp_type
        self._check_refit = check_refit

        from ...utils.device_policy import on_build_device

        with timed("curve.build.ois", pillars=len(ois_swaps),
                   interp=interp_type.name), on_build_device():
            self._prepare_curve_builder_inputs()
            self._plan = prepare_ois_plan(
                self.swap_times, self.year_fracs,
                loglinear_rates=all(r > 0 for r in self.swap_rates))

            # jitted constructor bootstrap: eager lax ops would each pay
            # a dispatch/compile. The plan is a jit ARGUMENT, never a
            # closure constant (docs/f64_notes.md rule 6). MODULE-LEVEL
            # jits: a fresh jax.jit(...) per curve owns a fresh cache, so
            # same-topology curves would recompile (~0.7 s each on
            # XLA:CPU). With refit on, bootstrap+repricing run as ONE
            # program.
            if check_refit:
                from ...parallel.book import compile_book

                book = compile_book(self._used_swaps, self._value_dt,
                                    index_dc=self._dc_type)
                times, dfs, refit_pvs = _bootstrap_refit_jit(
                    jnp.asarray(self.swap_rates), self._plan, book,
                    self._interp_type)
            else:
                times, dfs = _bootstrap_ois_jit(
                    jnp.asarray(self.swap_rates), self._plan)
            self._times = times
            self._dfs = dfs
            # numpy indexing: fancy-indexing the device array here is
            # ~14 EAGER op compiles per pillar shape (gather/add/
            # broadcast/select)
            self._repr_dfs = np.asarray(dfs)[
                np.asarray(self._plan.pillar_point) + 1]
            self._freq_type = FrequencyTypes.CONTINUOUS
            self._refresh_interpolator()

            if check_refit:
                with timed("curve.refit.ois", pillars=len(ois_swaps)):
                    self._check_refit_pvs(np.asarray(refit_pvs), SWAP_TOL)

    # ------------------------------------------------------------------

    def _prepare_curve_builder_inputs(self):
        """Per-swap (rate, pillar time, fixed-leg year fracs). Pillar time
        is anchored on the last *coupon* date (holiday-adjusted), in units
        of the float-leg day count's fixed denominator
        (ois_curve.py:128-154)."""
        self._dc_type = self._used_swaps[0]._float_leg._dc_type
        dcc = DayCount(self._dc_type)
        days_in_year = dcc.days_in_year()

        swap_rates: List[float] = []
        swap_times: List[float] = []
        year_fracs: List[list] = []
        prev_t = -1.0
        for swap in self._used_swaps:
            maturity_dt = swap._adjusted_fixed_dts[-1]
            tswap = (maturity_dt - self._value_dt) / days_in_year
            if tswap <= prev_t:
                raise LibError(
                    "Swaps must be sorted by increasing maturity")
            prev_t = tswap
            swap_rates.append(swap._fixed_coupon)
            swap_times.append(tswap)
            year_fracs.append(list(swap._fixed_leg._year_fracs))

        self.swap_rates = swap_rates
        self.swap_times = swap_times
        self.year_fracs = year_fracs
        return swap_rates

    # ------------------------------------------------------------------

    def _build_curve_ad(self, swap_rates):
        """Differentiable re-bootstrap from a rate vector (used by the risk
        engine's jacobians and scenario vmaps)."""
        return bootstrap_ois(jnp.asarray(swap_rates), self._plan)

    # ------------------------------------------------------------------

    def _check_refits(self, swap_tol: float):
        """Reprice every calibration swap on the built curve; hard-fail
        if any normalized PV exceeds the tolerance (ois_curve.py:344-358).

        All swaps reprice in ONE jitted batched kernel — per-swap
        valuation compiles a distinct program per payment count. (The
        constructor fuses this into the bootstrap program; this
        standalone path serves re-checks after bumps.)"""
        from ...parallel.book import compile_book

        book = compile_book(self._used_swaps, self._value_dt,
                            index_dc=self._dc_type)
        _, _, pvs = _bootstrap_refit_jit(
            jnp.asarray(self.swap_rates), self._plan, book,
            self._interp_type)
        self._check_refit_pvs(np.asarray(pvs), swap_tol)

    def _check_refit_pvs(self, pvs, swap_tol: float):
        for swap, pv in zip(self._used_swaps, pvs):
            v = pv / swap._notional
            if abs(v) > swap_tol:
                print(self)
                raise LibError(
                    f"Swap with maturity {swap._maturity_dt} not repriced: "
                    f"normalized PV {v:.3e} exceeds tol {swap_tol:.1e}")

    # ------------------------------------------------------------------

    def __repr__(self):
        s = label_to_string("OBJECT TYPE", type(self).__name__)
        s += label_to_string("VALUE DATE", self._value_dt)
        s += label_to_string("INTERP TYPE", self._interp_type)
        s += label_to_string("PILLARS", "")
        times = np.array(self._times)
        dfs = np.array(self._dfs)
        for t, df in zip(times, dfs):
            s += label_to_string(f"{t:10.6f}", f"{df:14.10f}")
        return s
