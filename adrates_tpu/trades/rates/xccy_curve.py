"""Cross-currency (foreign-in-domestic-collateral) discount curve.

Behavioral parity with /root/reference/cavour/trades/rates/xccy_curve.py:
flat-forward-basis intermediate nodes + closed-form par solve per pillar
(_build_curve 200-525 / _run_jax_bootstrap_impl 954-1206), ACT/365F df()
override (1210-1234), 1e-10 refit gate (1238-1272), and the jacobian set
the risk engine consumes (_jac_basis 594, _hess_basis 596-606,
_jac_foreign_curve_dfs 670, _mixed_hess_foreign_basis 673-693).

The solve itself lives in ops/xccy_bootstrap.py as a pillar-sequential
vectorized recursion (see that module for the rationale). FX convention
is unified: spot_fx = DOMESTIC per FOREIGN (the reference mixes inverse
conventions across modules).
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ...market.curves.discount_curve import DiscountCurve
from ...ops.xccy_bootstrap import XccyBootstrapPlan, bootstrap_xccy
from ...utils.date import Date
from ...utils.day_count import DayCount, DayCountTypes
from ...utils.error import LibError
from ...utils.frequency import FrequencyTypes
from ...utils.global_types import InterpTypes, SwapTypes
from ...utils.global_vars import gDaysInYear
from ...utils.helpers import label_to_string, times_from_dates

SWAP_TOL = 1e-10

# module-level jit, one compile per (plan shape, foreign scheme): the
# constructor bootstrap otherwise runs eager op-by-op (cold start).
# spot_fx rides as an argument, plan is a pytree.
from ...utils.compile_cache import build_jit  # noqa: E402

_bootstrap_xccy_jit = build_jit(
    bootstrap_xccy, static_argnames=("foreign_interp_type",))


class XccyCurve(DiscountCurve):
    """Discount curve for foreign cashflows under domestic collateral,
    calibrated so every basis swap prices to par in domestic currency."""

    def __init__(self,
                 value_dt: Date,
                 basis_swaps: list,
                 domestic_curve: DiscountCurve,
                 foreign_curve: DiscountCurve,
                 spot_fx: float,
                 interp_type: InterpTypes = InterpTypes.FLAT_FWD_RATES,
                 check_refit: bool = False,
                 use_ad: bool = True):
        self._value_dt = value_dt
        self._used_swaps = sorted(basis_swaps,
                                  key=lambda s: s._maturity_dt.serial())
        self._domestic_curve = domestic_curve
        self._foreign_curve = foreign_curve
        self._spot_fx = spot_fx
        self._interp_type = interp_type
        self._check_refit = check_refit
        self._use_ad = use_ad
        self._dc_type = DayCountTypes.ACT_365F
        self._freq_type = FrequencyTypes.CONTINUOUS

        from ...utils.observability import timed

        self.basis_spreads = [s._foreign_spread for s in self._used_swaps]
        self.swap_times = [(s._maturity_dt - value_dt) / gDaysInYear
                           for s in self._used_swaps]

        from ...utils.device_policy import on_build_device

        with timed("curve.build.xccy", pillars=len(basis_swaps),
                   interp=interp_type.name), on_build_device():
            self._plan = self._prepare_plan()
            self._pv_domestic = self._domestic_leg_pvs()
            self._fplan = self._foreign_plan()

            times, dfs = _bootstrap_xccy_jit(
                jnp.asarray(self.basis_spreads),
                jnp.asarray(self._pv_domestic),
                jnp.asarray(self._foreign_curve._times),
                jnp.asarray(self._foreign_curve._dfs),
                self._spot_fx, self._plan,
                foreign_interp_type=self._foreign_curve._interp_type,
                foreign_plan=self._fplan)
            self._times = times
            self._dfs = dfs
            self._repr_dfs = dfs
            self._refresh_interpolator()

            self._compute_jacobians()

            if check_refit:
                with timed("curve.refit.xccy", pillars=len(basis_swaps)):
                    self._check_refits(SWAP_TOL)

    # ------------------------------------------------------------------

    def _domestic_leg_pvs(self) -> List[float]:
        """Domestic-leg PV of each calibration swap on the domestic OIS
        curve (constant inputs to the basis bootstrap)."""
        return [s._domestic_leg.value(self._value_dt, self._domestic_curve,
                                      self._domestic_curve)
                for s in self._used_swaps]

    # ------------------------------------------------------------------

    def _prepare_plan(self) -> XccyBootstrapPlan:
        """Expand all foreign-leg payments into the static chain plan.

        Points sorted by (time, swap index); value-date flows contribute to
        the constant V0 terms; the flat-forward chain runs over the rest.
        """
        fdc = self._foreign_curve._dc_type
        points = []
        v0 = np.zeros(len(self._used_swaps))

        for k, swap in enumerate(self._used_swaps):
            leg = swap._foreign_leg
            if leg._leg_type != SwapTypes.PAY:
                raise LibError("Calibration foreign legs must be PAY")
            maturity_dt = swap._maturity_dt
            if not leg._notional_exchange:
                raise LibError("Calibration basis swaps need notional "
                               "exchange on the foreign leg")

            # initial exchange at effective date
            eff = leg._effective_dt
            if eff == self._value_dt:
                v0[k] += -leg._notional
            elif eff > self._value_dt:
                points.append(dict(
                    t=(eff - self._value_dt) / gDaysInYear,
                    pay_tf=times_from_dates(eff, self._value_dt, fdc),
                    start_t=0.0, end_t=0.0, notional=leg._notional,
                    spread_sens=0.0, alpha_ratio=1.0, is_mat=False,
                    is_notl=True, is_last=False, swap=k))

            notionals = leg._notionals()
            index_counter = DayCount(fdc)
            for j, pmnt_dt in enumerate(leg._payment_dts):
                if pmnt_dt < self._value_dt:
                    continue
                t = (pmnt_dt - self._value_dt) / gDaysInYear
                is_maturity = (pmnt_dt == maturity_dt)
                # forward coupons: pay basis over the foreign curve's
                # forward basis (value() parity — they only cancel when
                # the leg accrues on the curve's day count)
                ia = index_counter.year_frac(leg._start_accrued_dts[j],
                                             leg._end_accrued_dts[j])[0]
                pa = float(leg._year_fracs[j])
                rec = dict(
                    t=t,
                    pay_tf=times_from_dates(pmnt_dt, self._value_dt, fdc),
                    # forward DF queries happen at LEG-basis times — the
                    # same times value() asks the foreign curve for
                    # (swap_float_leg.py value(): index_curve.df(dts, dc)
                    # with dc = the leg's own day count)
                    start_t=times_from_dates(leg._start_accrued_dts[j],
                                             self._value_dt, leg._dc_type),
                    end_t=times_from_dates(leg._end_accrued_dts[j],
                                           self._value_dt, leg._dc_type),
                    notional=float(notionals[j]),
                    spread_sens=float(leg._year_fracs[j] * notionals[j]),
                    alpha_ratio=(pa / ia if ia > 0 else 1.0),
                    is_mat=is_maturity, is_notl=False,
                    is_last=is_maturity,  # final coupon carries +notional
                    swap=k)
                if pmnt_dt == self._value_dt:
                    raise LibError("Coupon at the value date unsupported")
                points.append(rec)

        points.sort(key=lambda p: (p["t"], p["swap"]))
        n = len(points)
        S = len(self._used_swaps)

        times = np.array([p["t"] for p in points])
        dt_chain = np.diff(np.concatenate([[0.0], times]))
        is_mat = np.array([p["is_mat"] for p in points])
        swap_of = np.array([p["swap"] for p in points], dtype=np.int32)
        seg_of = np.concatenate(
            [[0], np.cumsum(is_mat.astype(np.int32))[:-1]]).astype(np.int32)

        mat_pos = np.full(S, -1, dtype=np.int32)
        for i, p in enumerate(points):
            if p["is_mat"]:
                mat_pos[p["swap"]] = i
        if np.any(mat_pos < 0):
            raise LibError("Every calibration swap needs a maturity flow")

        live = ~is_mat
        swap_onehot = np.zeros((S, n))
        seg_onehot = np.zeros((S + 1, n))
        for i in range(n):
            if live[i]:
                swap_onehot[swap_of[i], i] = 1.0
            seg_onehot[seg_of[i], i] = 1.0

        # first occurrence of each (rounded) node time
        seen = {}
        unique_sel = []
        for i in range(n):
            key = round(times[i], 9)
            if key not in seen:
                seen[key] = i
                unique_sel.append(i)

        return XccyBootstrapPlan(
            times=times,
            pay_t_foreign=np.array([p["pay_tf"] for p in points]),
            start_t=np.array([p["start_t"] for p in points]),
            end_t=np.array([p["end_t"] for p in points]),
            notionals=np.array([p["notional"] for p in points]),
            spread_sens=np.array([p["spread_sens"] for p in points]),
            alpha_ratio=np.array([p["alpha_ratio"] for p in points]),
            dt_chain=dt_chain,
            is_mat=is_mat,
            is_notl=np.array([p["is_notl"] for p in points]),
            is_last=np.array([p["is_last"] for p in points]),
            swap_of=swap_of,
            seg_of=seg_of,
            mat_pos=mat_pos,
            swap_onehot=swap_onehot,
            seg_onehot=seg_onehot,
            v0=v0,
            unique_sel=np.array(unique_sel, dtype=np.int32),
            foreign_sign=-1.0)

    # ------------------------------------------------------------------

    def _foreign_plan(self):
        """Static-weight interp plan for the bootstrap's foreign-curve
        queries (the schedule AND the parent grid times are fixed once
        the curve set exists) — compile-size control for the build and
        jacobian kernels; None for fitted foreign schemes."""
        from ...ops.interpolation import (_SIMPLE_SCHEMES,
                                          simple_interp_plan)

        it = self._foreign_curve._interp_type
        if it not in _SIMPLE_SCHEMES:
            return None
        q = np.concatenate([np.asarray(self._plan.start_t),
                            np.asarray(self._plan.end_t),
                            np.asarray(self._plan.pay_t_foreign)])
        return simple_interp_plan(
            q, np.asarray(self._foreign_curve._times), it)

    def _dfs_from(self, spreads, foreign_dfs, consts=None):
        """XCCY node DFs as a function of (spreads, foreign grid DFs).

        ``consts`` carries (pv_domestic, foreign grid times, plan) as a jit
        argument, never a closure constant (docs/f64_notes.md rule 6)."""
        if consts is None:
            consts = self._jac_consts()
        _, dfs = bootstrap_xccy(
            spreads, consts["pv_dom"], consts["for_times"], foreign_dfs,
            self._spot_fx, consts["plan"],
            foreign_interp_type=self._foreign_curve._interp_type,
            foreign_plan=consts.get("fplan"))
        return dfs

    def _jac_consts(self):
        return dict(pv_dom=jnp.asarray(self._pv_domestic),
                    for_times=jnp.asarray(self._foreign_curve._times),
                    plan=self._plan,
                    fplan=getattr(self, "_fplan", None))

    def _compute_jacobians(self):
        """Reference-parity sensitivity tensors of the node DFs — LAZY:
        each tensor compiles+evaluates on first access (the risk engine
        composes its own jacobians, so curve construction shouldn't pay
        the ~30s of XLA compiles these cost; the reference computes them
        eagerly at build time, xccy_curve.py:594-693)."""
        self._jac_cache_xccy = {}

    def _lazy_jac(self, key, builder):
        from ...utils.device_policy import on_build_device
        cache = self._jac_cache_xccy
        if key not in cache:
            with on_build_device():
                cache[key] = builder()
        return cache[key]

    @property
    def _jac_basis(self):
        spreads = jnp.asarray(self.basis_spreads)
        fdfs = jnp.asarray(self._foreign_curve._dfs)
        C = self._jac_consts()
        return self._lazy_jac("jac_basis", lambda: jax.jit(
            jax.jacrev(self._dfs_from, argnums=0))(spreads, fdfs, C))

    @property
    def _hess_basis(self):
        spreads = jnp.asarray(self.basis_spreads)
        fdfs = jnp.asarray(self._foreign_curve._dfs)
        C = self._jac_consts()
        return self._lazy_jac("hess_basis", lambda: jax.jit(jax.jacfwd(
            jax.jacrev(self._dfs_from, argnums=0),
            argnums=0))(spreads, fdfs, C))

    @property
    def _jac_foreign_curve_dfs(self):
        spreads = jnp.asarray(self.basis_spreads)
        fdfs = jnp.asarray(self._foreign_curve._dfs)
        C = self._jac_consts()
        return self._lazy_jac("jac_foreign", lambda: jax.jit(
            jax.jacrev(self._dfs_from, argnums=1))(spreads, fdfs, C))

    @property
    def _mixed_hess_foreign_basis(self):
        spreads = jnp.asarray(self.basis_spreads)
        fdfs = jnp.asarray(self._foreign_curve._dfs)
        C = self._jac_consts()

        def build():
            mixed = jax.jit(jax.jacrev(
                jax.jacfwd(self._dfs_from, argnums=1),
                argnums=0))(spreads, fdfs, C)
            # [n_xccy, n_basis, n_foreign]
            return jnp.transpose(mixed, (0, 2, 1))
        return self._lazy_jac("mixed_hess", build)

    # ------------------------------------------------------------------

    def df(self, dt, day_count=None):
        """DFs always under ACT/365F — node times are stored in those
        units (parity: xccy_curve.py:1210-1234; day_count is ignored)."""
        times = times_from_dates(dt, self._value_dt, DayCountTypes.ACT_365F)
        dfs = self._df(jnp.atleast_1d(jnp.asarray(times)))
        if isinstance(dt, Date):
            return float(dfs[0])
        return np.array(dfs)

    # ------------------------------------------------------------------

    def _check_refits(self, swap_tol: float):
        """Every calibration basis swap must have |PV|/notional < tol in
        domestic currency on the built curve."""
        for swap in self._used_swaps:
            v = swap.value(value_dt=self._value_dt,
                           domestic_discount_curve=self._domestic_curve,
                           foreign_discount_curve=self._foreign_curve,
                           xccy_discount_curve=self,
                           spot_fx=self._spot_fx)
            v_norm = v / swap._domestic_notional
            if abs(v_norm) > swap_tol:
                raise LibError(
                    f"XCCY swap with maturity {swap._maturity_dt} not "
                    f"repriced: normalized PV {v_norm:.3e} exceeds "
                    f"{swap_tol:.1e}")

    # ------------------------------------------------------------------

    def __repr__(self):
        s = label_to_string("OBJECT TYPE", type(self).__name__)
        s += label_to_string("VALUATION DATE", self._value_dt)
        s += label_to_string("SPOT FX (dom/for)", self._spot_fx)
        s += label_to_string("INTERPOLATION", self._interp_type)
        for i, swap in enumerate(self._used_swaps):
            s += label_to_string(
                f"{self.swap_times[i]:8.4f}",
                f"{self.basis_spreads[i] * 1e4:8.2f}bp")
        return s
