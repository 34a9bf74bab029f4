"""XCCY multi-curve risk: deltas/gammas vs domestic OIS, foreign OIS and
basis spreads, plus the foreign x basis cross-gamma.

Role parity with /root/reference/cavour/market/position/engine.py
(_compute_xccy 1411-1988). Risk views preserved:
 - domestic delta/gamma: partials w.r.t. domestic quotes (XCCY curve fixed)
 - foreign delta/gamma: partials w.r.t. foreign quotes with the XCCY curve
   HELD FIXED (documented policy, engine.py:1692-1700)
 - basis delta/gamma: through the XCCY bootstrap (spreads -> node DFs -> PV)
 - cross-gamma (foreign x basis): FULL mixed second derivative of
   PV(for_rates, spreads) through both the pricing kernel and the
   bootstrap — the reference keeps only the bootstrap mixed-hessian term
   (engine.py:1936-1945); including all terms is an upgrade, not a port.

Everything is one pure function PV(dom_rates, for_rates, spreads) composed
from the OIS bootstrap, the XCCY bootstrap and the leg kernels. All
requested outputs are computed inside ONE jitted, content-key-cached
analytics function (cached on the XCCY curve, keyed on static config +
tensor shapes) and returned as a SINGLE packed vector: re-pricing a new
same-shape trade does zero compiles and one device->host transfer.
"""

from __future__ import annotations

from typing import Set

import jax
import jax.numpy as jnp
import numpy as np

from ...ops.bootstrap import bootstrap_ois
from ...ops.pricers import FixedLegTensor, FloatLegTensor, pv_fixed_leg, \
    pv_float_leg
from ...ops.xccy_bootstrap import bootstrap_xccy
from ...requests.results import (AnalyticsResult, Cashflows, CrossGamma,
                                 Delta, Gamma, Risk, Valuation)
from ...utils.date import Date
from ...utils.day_count import DayCount, DayCountTypes
from ...utils.error import LibError
from ...utils.global_types import CurveTypes, RequestTypes, SwapTypes
from ...utils.helpers import times_from_dates, to_tenor
from ...trades.rates.swap_fixed_leg import SwapFixedLeg
from ...trades.rates.swap_float_leg import SwapFloatLeg
from ...trades.rates.xccy_curve import XccyCurve


def find_xccy_curve(model, derivative, allow_fallback: bool = False):
    """Locate the XCCY curve calibrated for this currency pair by EXACT
    index match. A mismatched pair raises — discounting a trade on some
    other pair's basis curve silently mislabels the whole risk ladder
    (the reference's engine routes by a
    constructed curve name and KeyErrors, engine.py:1429-1442).
    ``allow_fallback=True`` opts back in to "any single XccyCurve" for
    deliberately index-agnostic setups."""
    dom_idx = derivative._domestic_floating_index
    for_idx = derivative._foreign_floating_index
    candidates = [(name, c) for name, c in model._curves_dict.items()
                  if isinstance(c, XccyCurve)]
    for name, curve in candidates:
        if (getattr(curve, "_domestic_index", None) == dom_idx
                and getattr(curve, "_foreign_index", None) == for_idx):
            return name, curve
    if allow_fallback and len(candidates) == 1:
        return candidates[0]
    raise LibError(
        f"No XCCY curve found in model for pair "
        f"{for_idx.name}/{dom_idx.name}. Build one with "
        f"model.build_xccy_curve(...). Available XCCY curves: "
        f"{[n for n, _ in candidates]}")


def basis_curve_type(foreign_ccy, domestic_ccy) -> CurveTypes:
    name = f"{foreign_ccy.name}_{domestic_ccy.name}_BASIS"
    try:
        return CurveTypes[name]
    except KeyError:
        raise LibError(
            f"No CurveTypes member {name} for the basis risk ladder — "
            f"add it to utils/global_types.py rather than mislabeling "
            f"the ladder") from None


# backwards-compatible private aliases
_find_xccy_curve = find_xccy_curve
_basis_curve_type = basis_curve_type


def _float_leg_xccy_tensor(leg: SwapFloatLeg, value_dt: Date,
                           foreign_dc: DayCountTypes) -> FloatLegTensor:
    """Foreign float leg: payment/exchange times in XCCY curve units
    (ACT/365F), forward DF queries at LEG-basis times with the divisor in
    the foreign curve's basis — exactly what value() asks the curves for
    (parity: engine.py:1496-1520 + swap_float_leg value())."""
    xccy_dc = DayCountTypes.ACT_365F
    n = len(leg._payment_dts)
    return FloatLegTensor(
        payment_times=np.asarray(
            times_from_dates(leg._payment_dts, value_dt, xccy_dc)),
        start_times=np.asarray(
            times_from_dates(leg._start_accrued_dts, value_dt,
                             leg._dc_type)),
        end_times=np.asarray(
            times_from_dates(leg._end_accrued_dts, value_dt,
                             leg._dc_type)),
        pay_alphas=np.array(leg._year_fracs, dtype=np.float64),
        index_alphas=np.array(
            [DayCount(foreign_dc).year_frac(s, e)[0]
             for s, e in zip(leg._start_accrued_dts, leg._end_accrued_dts)],
            dtype=np.float64),
        spreads=np.full(n, leg._spread),
        notionals=leg._notionals(),
        principal=np.float64(leg._principal * leg._notional),
        leg_sign=np.float64(
            1.0 if leg._leg_type == SwapTypes.RECEIVE else -1.0),
        value_time=np.float64(0.0),
        first_fixing_rate=np.float64(0.0),
        notional_exchange_amount=np.float64(
            float(leg._notional) if leg._notional_exchange else 0.0),
        effective_time=np.float64(
            times_from_dates(leg._effective_dt, value_dt, xccy_dc)),
        maturity_time=np.float64(
            times_from_dates(leg._maturity_dt, value_dt, xccy_dc)),
        cap_rate=np.float64(np.inf),
        floor_rate=np.float64(-np.inf),
        override_first=False,
        notional_exchange=leg._notional_exchange,
        has_cap_floor=False)


def _fixed_exchange_times(derivative, value_dt):
    return (np.float64(times_from_dates(derivative._effective_dt, value_dt,
                                        DayCountTypes.ACT_ACT_ISDA)),
            np.float64(times_from_dates(derivative._maturity_dt, value_dt,
                                        DayCountTypes.ACT_ACT_ISDA)))


def compute_xccy(engine, derivative, reqs: Set[RequestTypes]
                 ) -> AnalyticsResult:
    model = engine.model
    # bracket access raises LibError naming the missing curve (strict
    # routing: never price against a half-populated model)
    dom_curve = model.curves[derivative._domestic_floating_index.name]
    for_curve = model.curves[derivative._foreign_floating_index.name]
    xccy_name, xccy_curve = find_xccy_curve(model, derivative)
    value_dt = dom_curve._value_dt

    dom_it = dom_curve._interp_type
    for_it = for_curve._interp_type
    xccy_it = xccy_curve._interp_type

    # --- compile legs ---------------------------------------------------
    dom_leg = derivative._domestic_leg
    for_leg = derivative._foreign_leg
    dom_is_fixed = isinstance(dom_leg, SwapFixedLeg)
    for_is_fixed = isinstance(for_leg, SwapFixedLeg)

    # Every f64 input (tensors, grids, scalars like spot FX / notionals)
    # rides in the consts pytree as a jit ARGUMENT, never a closure
    # constant (docs/f64_notes.md rule 6).
    consts = dict(spot_fx=np.float64(xccy_curve._spot_fx))
    if dom_is_fixed:
        eff_t, mat_t = _fixed_exchange_times(derivative, value_dt)
        consts.update(
            dom_tensor=dom_leg.tensor(value_dt),
            eff_t=eff_t, mat_t=mat_t,
            dom_notional=np.float64(derivative._domestic_notional),
            dom_sign=np.float64(
                1.0 if derivative._domestic_leg_type == SwapTypes.RECEIVE
                else -1.0))
    else:
        consts.update(dom_tensor=dom_leg.tensor(
            value_dt, index_dc=dom_curve._dc_type))

    if for_is_fixed:
        # fixed foreign leg discounted on the XCCY grid: times in ACT/365F
        xdc = DayCountTypes.ACT_365F
        consts.update(
            for_tensor=FixedLegTensor(
                payment_times=np.asarray(
                    times_from_dates(for_leg._payment_dts, value_dt, xdc)),
                payments=np.array(for_leg._payments, dtype=np.float64),
                principal=np.float64(
                    for_leg._principal * for_leg._notional),
                leg_sign=np.float64(
                    1.0 if for_leg._leg_type == SwapTypes.RECEIVE
                    else -1.0),
                value_time=np.float64(0.0)),
            for_eff_t=np.float64(times_from_dates(
                derivative._effective_dt, value_dt, xdc)),
            for_mat_t=np.float64(times_from_dates(
                derivative._maturity_dt, value_dt, xdc)),
            for_notional=np.float64(derivative._foreign_notional),
            for_sign=np.float64(
                1.0 if for_leg._leg_type == SwapTypes.RECEIVE else -1.0))
    else:
        consts.update(for_tensor=_float_leg_xccy_tensor(
            for_leg, value_dt, for_curve._dc_type))

    want = (RequestTypes.VALUE in reqs, RequestTypes.DELTA in reqs,
            RequestTypes.GAMMA in reqs)
    n_d = len(dom_curve.swap_rates)
    n_f = len(for_curve.swap_rates)
    n_s = len(xccy_curve.basis_spreads)

    cache = engine._curve_jit_cache(xccy_curve)
    curve_consts = cache.get("_consts_xccy")
    if curve_consts is None:
        curve_consts = jax.device_put(dict(
            dom_plan=dom_curve._plan, for_plan=for_curve._plan,
            xccy_plan=xccy_curve._plan,
            xccy_times_grid=jnp.asarray(xccy_curve._times),
            xccy_dfs0=jnp.asarray(xccy_curve._dfs),
            pv_domestic=jnp.asarray(xccy_curve._pv_domestic)))
        cache["_consts_xccy"] = curve_consts
    consts.update(curve_consts)

    key = ("xccy", dom_is_fixed, for_is_fixed, dom_it, for_it, xccy_it,
           engine._tensor_signature(consts["dom_tensor"]),
           engine._tensor_signature(consts["for_tensor"]),
           n_d, n_f, n_s, want)

    def build():
        def exchange_pv(dfs, times, it, eff_t, mat_t, notional, sign):
            from ...ops.interpolation import interp_df
            q = jnp.stack([eff_t, mat_t])
            d = interp_df(q, times, dfs, it)
            amts = jnp.stack([-notional * sign, notional * sign])
            live = q >= 0.0
            return jnp.sum(jnp.where(live, amts * d, 0.0))

        def pv_fn(dom_rates, for_rates, xccy_dfs, C):
            dom_times, dom_dfs = bootstrap_ois(dom_rates, C["dom_plan"])
            for_times, for_dfs = bootstrap_ois(for_rates, C["for_plan"])

            # domestic leg on the domestic OIS curve
            if dom_is_fixed:
                dom_pv = pv_fixed_leg(dom_dfs, dom_times, dom_it,
                                      C["dom_tensor"])
                dom_pv = dom_pv + exchange_pv(dom_dfs, dom_times, dom_it,
                                              C["eff_t"], C["mat_t"],
                                              C["dom_notional"],
                                              C["dom_sign"])
            else:
                dom_pv = pv_float_leg(dom_dfs, dom_times, dom_it,
                                      C["dom_tensor"])

            # foreign leg: projected on foreign OIS, discounted on XCCY
            if for_is_fixed:
                for_pv = pv_fixed_leg(xccy_dfs, C["xccy_times_grid"],
                                      xccy_it, C["for_tensor"])
                for_pv = for_pv + exchange_pv(
                    xccy_dfs, C["xccy_times_grid"], xccy_it,
                    C["for_eff_t"], C["for_mat_t"], C["for_notional"],
                    C["for_sign"])
            else:
                for_pv = pv_float_leg(xccy_dfs, C["xccy_times_grid"],
                                      xccy_it, C["for_tensor"],
                                      idx_dfs=for_dfs, idx_times=for_times,
                                      idx_interp_type=for_it)

            return dom_pv + C["spot_fx"] * for_pv

        def xccy_dfs_fn(spreads, for_rates, C):
            for_times, for_dfs = bootstrap_ois(for_rates, C["for_plan"])
            _, dfs = bootstrap_xccy(spreads, C["pv_domestic"], for_times,
                                    for_dfs, C["spot_fx"], C["xccy_plan"],
                                    foreign_interp_type=for_it)
            return dfs

        def basis_pv(spreads, dom_rates, for_rates, C):
            return pv_fn(dom_rates, for_rates,
                         xccy_dfs_fn(spreads, for_rates, C), C)

        def analytics(dom_rates, for_rates, spreads, C):
            xdfs0 = C["xccy_dfs0"]
            parts = []
            if want[0]:
                parts.append(jnp.reshape(
                    pv_fn(dom_rates, for_rates, xdfs0, C), (1,)))
            if want[1]:
                parts.append(jax.jacrev(pv_fn, argnums=0)(
                    dom_rates, for_rates, xdfs0, C))
                parts.append(jax.jacrev(pv_fn, argnums=1)(
                    dom_rates, for_rates, xdfs0, C))
                parts.append(jax.jacrev(basis_pv, argnums=0)(
                    spreads, dom_rates, for_rates, C))
            if want[2]:
                parts.append(jax.jacfwd(jax.jacrev(pv_fn, argnums=0),
                                        argnums=0)(
                    dom_rates, for_rates, xdfs0, C).ravel())
                parts.append(jax.jacfwd(jax.jacrev(pv_fn, argnums=1),
                                        argnums=1)(
                    dom_rates, for_rates, xdfs0, C).ravel())
                parts.append(jax.jacfwd(jax.jacrev(basis_pv, argnums=0),
                                        argnums=0)(
                    spreads, dom_rates, for_rates, C).ravel())
                # cross-gamma foreign x basis: FULL mixed second
                # derivative of f(for, spreads)
                f_cross = lambda fr, s, C_: pv_fn(
                    dom_rates, fr, xccy_dfs_fn(s, fr, C_), C_)
                parts.append(jax.jacfwd(jax.jacrev(f_cross, argnums=0),
                                        argnums=1)(
                    for_rates, spreads, C).ravel())
            return jnp.concatenate(parts)

        return analytics

    fn = engine._cached_jit(cache, key, build)
    packed = fn(jnp.asarray(dom_curve.swap_rates),
                jnp.asarray(for_curve.swap_rates),
                jnp.asarray(xccy_curve.basis_spreads), consts)

    sizes = []
    if want[0]:
        sizes.append(("pv", (1,)))
    if want[1]:
        sizes += [("d_dom", (n_d,)), ("d_for", (n_f,)),
                  ("d_basis", (n_s,))]
    if want[2]:
        sizes += [("g_dom", (n_d, n_d)), ("g_for", (n_f, n_f)),
                  ("g_basis", (n_s, n_s)), ("cross", (n_f, n_s))]
    raw = engine._unpack(packed, sizes)

    dom_ccy = derivative._domestic_currency
    basis_ct = basis_curve_type(derivative._foreign_currency, dom_ccy)
    dom_tenors = to_tenor(list(dom_curve.swap_times))
    for_tenors = to_tenor(list(for_curve.swap_times))
    basis_tenors = to_tenor(list(xccy_curve.swap_times))

    value = delta = gamma = None
    if want[0]:
        value = Valuation(float(raw["pv"][0]), dom_ccy)
    if want[1]:
        delta = Risk([
            Delta(raw["d_dom"] * 1e-4, dom_tenors, dom_ccy,
                  derivative._domestic_floating_index),
            Delta(raw["d_for"] * 1e-4, for_tenors, dom_ccy,
                  derivative._foreign_floating_index),
            Delta(raw["d_basis"] * 1e-4, basis_tenors, dom_ccy, basis_ct)])
    if want[2]:
        cross_gamma = CrossGamma(
            risk_matrix=raw["cross"] * 1e-8,
            tenors_curve1=for_tenors, tenors_curve2=basis_tenors,
            currency=dom_ccy,
            curve_type_1=derivative._foreign_floating_index,
            curve_type_2=basis_ct)
        gamma = Risk([
            Gamma(raw["g_dom"] * 1e-8, dom_tenors, dom_ccy,
                  derivative._domestic_floating_index),
            Gamma(raw["g_for"] * 1e-8, for_tenors, dom_ccy,
                  derivative._foreign_floating_index),
            Gamma(raw["g_basis"] * 1e-8, basis_tenors, dom_ccy, basis_ct)],
            cross_gammas=[cross_gamma])

    cashflows = None
    if RequestTypes.CASHFLOWS in reqs:
        pay_dom = dom_leg._leg_type == SwapTypes.PAY
        if dom_is_fixed:
            dom_leg.value(value_dt, dom_curve)
        else:
            dom_leg.value(value_dt, dom_curve, dom_curve)
        if for_is_fixed:
            for_leg.value(value_dt, xccy_curve)
        else:
            for_leg.value(value_dt, xccy_curve, for_curve)
        items = engine._extract_leg_cashflows(
            dom_leg, "Domestic_Pay" if pay_dom else "Domestic_Rec")
        items += engine._extract_leg_cashflows(
            for_leg, "Foreign_Rec" if pay_dom else "Foreign_Pay")
        cashflows = Cashflows(items, dom_ccy)

    return AnalyticsResult(value=value, risk=delta, gamma=gamma,
                           cashflows=cashflows)
