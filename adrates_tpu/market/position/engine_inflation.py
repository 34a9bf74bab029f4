"""Inflation swap engine paths: ZCIS and YoY with AD risk to both the
discount curve and the ZCIS breakeven curve.

Role parity with /root/reference/cavour/market/position/engine.py
(_compute_yoy_iis 986-1408: delta/gamma to discount rates AND breakevens
via the inflation-curve jacobian chain). Upgrades over the reference:
 - the discount x breakeven cross-gamma is computed (the reference leaves
   it as TODO = 0, engine.py:1317);
 - a ZCIS engine path exists (the reference raises LibError for ZCIS).

CPI references are classified at trade-compile time: lagged dates covered
by historical fixings become constants; future ones become
base_cpi * factor(t) with the factor curve rebuilt differentiably from the
breakeven vector.
"""

from __future__ import annotations

from typing import Set

import jax
import jax.numpy as jnp
import numpy as np

from ...market.curves.inflation_curve import InflationCurve
from ...ops.bootstrap import bootstrap_ois
from ...ops.interpolation import interp_df, interp_fit
from ...ops.pricers import pv_fixed_leg
from ...requests.results import (AnalyticsResult, CashflowItem, Cashflows,
                                 CrossGamma, Delta, Gamma, Risk, Valuation)
from ...utils.currency import CurrencyTypes
from ...utils.day_count import DayCount, DayCountTypes
from ...utils.error import LibError
from ...utils.global_types import CurveTypes, RequestTypes, SwapTypes
from ...utils.helpers import times_from_dates, to_tenor

_DEFAULT_OIS = {
    CurrencyTypes.GBP: "GBP_OIS_SONIA",
    CurrencyTypes.USD: "USD_OIS_SOFR",
    CurrencyTypes.EUR: "EUR_OIS_ESTR",
    CurrencyTypes.JPY: "JPY_OIS_TONAR",
    CurrencyTypes.CHF: "CHF_OIS_SARON",
    CurrencyTypes.AUD: "AUD_OIS_AONIA",
    CurrencyTypes.CAD: "CAD_OIS_CORRA",
}

_DEFAULT_INFL_CT = {
    CurrencyTypes.GBP: CurveTypes.GBP_RPI_INFLATION,
    CurrencyTypes.USD: CurveTypes.USD_CPI_INFLATION,
    CurrencyTypes.EUR: CurveTypes.EUR_HICP_INFLATION,
}


def _curves_for(engine, derivative):
    ccy = derivative._inflation_index._currency
    if ccy not in _DEFAULT_OIS:
        raise LibError(f"No default OIS curve for currency {ccy}")
    ois_curve = getattr(engine.model.curves, _DEFAULT_OIS[ccy])
    infl_curve = derivative._inflation_index._inflation_curve
    if infl_curve is None:
        for curve in engine.model._curves_dict.values():
            if isinstance(curve, InflationCurve):
                infl_curve = curve
                break
    if infl_curve is None:
        raise LibError(
            "No inflation curve available: set one on the index via "
            "set_inflation_curve() or model.build_inflation_curve().")
    infl_ct = getattr(infl_curve, "_curve_type", None) \
        or _DEFAULT_INFL_CT.get(ccy, CurveTypes.GBP_RPI_INFLATION)
    return ois_curve, infl_curve, infl_ct


def _cpi_ref(index, infl_curve, ref_dt, value_dt):
    """Classify a CPI reference: (is_fixed, fixed_value, t_curve, seas).

    Lag is applied; if the lagged date has a historical fixing the value is
    a constant; otherwise it resolves to seas * base_cpi * factor(t_curve)
    differentiably.
    """
    lagged = index._apply_lag(ref_dt)
    hist = index._get_historical_index(lagged)
    seas = index._seasonality_factors.get(lagged.m(), 1.0) \
        if index._use_seasonality else 1.0
    if hist is not None:
        return True, hist * seas, 0.0, seas
    dc = DayCount(infl_curve._dc_type)
    t = dc.year_frac(infl_curve._value_dt, lagged)[0]
    return False, 0.0, t, seas


def _factor_fn(infl_curve):
    """factor(t) interpolator over the (differentiable) factor grid.
    The pillar-time grid travels as an argument, never a closure constant
    (docs/f64_notes.md rule 6)."""
    it = infl_curve._interp_type

    def factor_at(breakevens, t_query, swap_times):
        factors = jnp.power(1.0 + breakevens, swap_times)
        times = jnp.concatenate([jnp.zeros(1), swap_times])
        factors = jnp.concatenate([jnp.ones(1), factors])
        aux = interp_fit(times, factors, it)
        return interp_df(t_query, times, factors, it, aux)

    return factor_at


def _risk_package(engine, infl_curve, key, make_pv, ois_rates, breakevens,
                  consts, reqs, ccy, ois_ct, infl_ct, ois_tenors,
                  infl_tenors):
    """Packed, content-key-cached inflation analytics: ONE jitted call
    (cached on the inflation curve) returns PV + both delta ladders + both
    gamma matrices + the discount x breakeven cross-gamma as a single flat
    vector — zero recompiles for a new same-shape trade, one device->host
    transfer per request (the round-1 version rebuilt lambdas and called
    jax.jit inline per compute(), missing the jit cache every time)."""
    from .engine import Engine

    want = (RequestTypes.VALUE in reqs, RequestTypes.DELTA in reqs,
            RequestTypes.GAMMA in reqs)
    if not any(want):
        return None, None, None
    n0 = int(ois_rates.shape[0])
    n1 = int(breakevens.shape[0])
    cache = Engine._curve_jit_cache(infl_curve)
    full_key = key + (Engine._tensor_signature(consts), n0, n1, want)
    fn = Engine._cached_jit(
        cache, full_key,
        lambda: Engine._two_curve_analytics(make_pv(), want))
    packed = fn(ois_rates, breakevens, consts)

    sizes = []
    if want[0]:
        sizes.append(("pv", (1,)))
    if want[1]:
        sizes += [("d0", (n0,)), ("d1", (n1,))]
    if want[2]:
        sizes += [("g0", (n0, n0)), ("g1", (n1, n1)), ("cross", (n0, n1))]
    raw = Engine._unpack(packed, sizes)

    value = delta = gamma = None
    if want[0]:
        value = Valuation(float(raw["pv"][0]), ccy)
    if want[1]:
        delta = Risk([
            Delta(raw["d0"] * 1e-4, ois_tenors, ccy, ois_ct),
            Delta(raw["d1"] * 1e-4, infl_tenors, ccy, infl_ct)])
    if want[2]:
        cross_gamma = CrossGamma(
            risk_matrix=raw["cross"] * 1e-8,
            tenors_curve1=ois_tenors, tenors_curve2=infl_tenors,
            currency=ccy, curve_type_1=ois_ct, curve_type_2=infl_ct)
        gamma = Risk([
            Gamma(raw["g0"] * 1e-8, ois_tenors, ccy, ois_ct),
            Gamma(raw["g1"] * 1e-8, infl_tenors, ccy, infl_ct)],
            cross_gammas=[cross_gamma])
    return value, delta, gamma


def compute_yoy_iis(engine, derivative, reqs: Set[RequestTypes]
                    ) -> AnalyticsResult:
    model = engine.model
    ois_curve, infl_curve, infl_ct = _curves_for(engine, derivative)
    value_dt = ois_curve._value_dt
    index = derivative._inflation_index
    leg = derivative._inflation_leg
    ccy = index._currency
    ois_ct = CurveTypes[_DEFAULT_OIS[ccy]]

    # fixed leg tensor
    fixed_tensor = derivative._fixed_leg.tensor(value_dt)

    # YoY leg compile: classify every CPI reference
    n = len(leg._payment_dts)
    rows = []
    for i in range(n):
        if leg._payment_dts[i] <= value_dt:
            continue
        s_fixed, s_val, s_t, _ = _cpi_ref(index, infl_curve,
                                          leg._yoy_start_dts[i], value_dt)
        e_fixed, e_val, e_t, _ = _cpi_ref(index, infl_curve,
                                          leg._yoy_end_dts[i], value_dt)
        pay_t = times_from_dates(leg._payment_dts[i], value_dt,
                                 leg._dc_type)
        rows.append((s_fixed, s_val, s_t, e_fixed, e_val, e_t, pay_t,
                     leg._year_fracs[i]))

    s_fixed = np.array([r[0] for r in rows])
    s_val = np.array([r[1] for r in rows])
    s_t = np.array([r[2] for r in rows])
    e_fixed = np.array([r[3] for r in rows])
    e_val = np.array([r[4] for r in rows])
    e_t = np.array([r[5] for r in rows])
    pay_t = np.array([r[6] for r in rows])
    alphas = np.array([r[7] for r in rows])
    seas_s = np.array([index._seasonality_factors.get(
        index._apply_lag(leg._yoy_start_dts[i]).m(), 1.0)
        if index._use_seasonality else 1.0 for i in range(n)
        if leg._payment_dts[i] > value_dt])
    seas_e = np.array([index._seasonality_factors.get(
        index._apply_lag(leg._yoy_end_dts[i]).m(), 1.0)
        if index._use_seasonality else 1.0 for i in range(n)
        if leg._payment_dts[i] > value_dt])

    factor_at = _factor_fn(infl_curve)
    plan = ois_curve._plan
    it = ois_curve._interp_type

    # every f64 value (arrays AND scalars) rides in the consts pytree as a
    # jit argument, never a closure constant — docs/f64_notes.md rule 6
    consts = dict(plan=plan, fixed_tensor=fixed_tensor, pay_t=pay_t,
                  s_t=s_t, e_t=e_t, s_val=s_val, e_val=e_val,
                  seas_s=seas_s, seas_e=seas_e, alphas=alphas,
                  s_fixed=s_fixed, e_fixed=e_fixed,
                  base_cpi=np.float64(infl_curve._base_cpi),
                  leg_sign=np.float64(
                      1.0 if leg._leg_type == SwapTypes.RECEIVE else -1.0),
                  spread=np.float64(leg._spread),
                  notional=np.float64(leg._notional),
                  infl_times=np.asarray(infl_curve.swap_times,
                                        dtype=np.float64))

    def make_pv():
        def pv_fn(ois_rates, breakevens, C):
            times, dfs = bootstrap_ois(ois_rates, C["plan"])
            aux = interp_fit(times, dfs, it)
            q = jnp.concatenate([C["pay_t"], jnp.zeros(1)])
            out = interp_df(q, times, dfs, it, aux)
            df_pay = out[:-1] / out[-1]

            f_s = factor_at(breakevens, C["s_t"], C["infl_times"])
            f_e = factor_at(breakevens, C["e_t"], C["infl_times"])
            cpi_s = jnp.where(C["s_fixed"], C["s_val"],
                              C["seas_s"] * C["base_cpi"] * f_s)
            cpi_e = jnp.where(C["e_fixed"], C["e_val"],
                              C["seas_e"] * C["base_cpi"] * f_e)
            yoy = cpi_e / cpi_s - 1.0
            payments = C["notional"] * C["alphas"] * (yoy + C["spread"])
            infl_pv = C["leg_sign"] * jnp.sum(payments * df_pay)

            fixed_pv = pv_fixed_leg(dfs, times, it, C["fixed_tensor"])
            return fixed_pv + infl_pv
        return pv_fn

    value, delta, gamma = _risk_package(
        engine, infl_curve, ("yoy", it, infl_curve._interp_type), make_pv,
        jnp.asarray(ois_curve.swap_rates),
        jnp.asarray(infl_curve.breakeven_rates), consts, reqs, ccy, ois_ct,
        infl_ct, to_tenor(list(ois_curve.swap_times)),
        list(infl_curve.tenors))

    cashflows = None
    if RequestTypes.CASHFLOWS in reqs:
        derivative.value(value_dt, ois_curve, infl_curve)
        pay_fixed = derivative._fixed_leg._leg_type == SwapTypes.PAY
        items = engine._extract_leg_cashflows(
            derivative._fixed_leg,
            "Fixed_Pay" if pay_fixed else "Fixed_Rec")
        for i, dt in enumerate(leg._payment_dts):
            items.append(CashflowItem(
                payment_date=dt, notional=leg._notional,
                payment_fraction=float(leg._yoy_rates[i]),
                accrual_period=float(leg._year_fracs[i]),
                amount=float(leg._payments[i]),
                discount_factor=float(leg._dfs[i]),
                discounted_amount=float(leg._pvs[i]),
                leg_type="Inflation_Rec" if pay_fixed else "Inflation_Pay"))
        cashflows = Cashflows(items, ccy)

    return AnalyticsResult(value=value, risk=delta, gamma=gamma,
                           cashflows=cashflows)


def compute_zcis(engine, derivative, reqs: Set[RequestTypes]
                 ) -> AnalyticsResult:
    """ZCIS engine path (the reference has none — engine.py:89-124 raises).
    Single exchange: fixed N[(1+r)^T - 1] vs inflation N[I_T/I_0 - 1]."""
    ois_curve, infl_curve, infl_ct = _curves_for(engine, derivative)
    value_dt = ois_curve._value_dt
    index = derivative._inflation_index
    ccy = index._currency
    ois_ct = CurveTypes[_DEFAULT_OIS[ccy]]

    year_frac = derivative.year_frac()
    fixed_payment = derivative._notional \
        * ((1.0 + derivative._fixed_rate) ** year_frac - 1.0)
    fixed_sign = -1.0 if derivative._fixed_leg_type == SwapTypes.PAY \
        else 1.0
    infl_sign = -fixed_sign

    b_fixed, b_val, b_t, _ = _cpi_ref(index, infl_curve,
                                      derivative._effective_dt, value_dt)
    f_fixed, f_val, f_t, _ = _cpi_ref(index, infl_curve,
                                      derivative._maturity_dt, value_dt)
    seas_b = index._seasonality_factors.get(
        index._apply_lag(derivative._effective_dt).m(), 1.0) \
        if index._use_seasonality else 1.0
    seas_f = index._seasonality_factors.get(
        index._apply_lag(derivative._maturity_dt).m(), 1.0) \
        if index._use_seasonality else 1.0

    pay_t = times_from_dates(derivative._payment_dt, value_dt,
                             DayCountTypes.ACT_365F)
    live = derivative._payment_dt > value_dt

    factor_at = _factor_fn(infl_curve)
    plan = ois_curve._plan
    it = ois_curve._interp_type

    # f64 scalars/arrays as jit args (docs/f64_notes.md rule 6)
    consts = dict(plan=plan,
                  q=np.array([pay_t, 0.0], dtype=np.float64),
                  tq=np.array([b_t, f_t], dtype=np.float64),
                  b_val=np.float64(b_val), f_val=np.float64(f_val),
                  seas_b=np.float64(seas_b), seas_f=np.float64(seas_f),
                  base_cpi=np.float64(infl_curve._base_cpi),
                  notional=np.float64(derivative._notional),
                  fixed_amt=np.float64(fixed_sign * fixed_payment),
                  infl_sign=np.float64(infl_sign),
                  infl_times=np.asarray(infl_curve.swap_times,
                                        dtype=np.float64))

    def make_pv():
        def pv_fn(ois_rates, breakevens, C):
            times, dfs = bootstrap_ois(ois_rates, C["plan"])
            aux = interp_fit(times, dfs, it)
            out = interp_df(C["q"], times, dfs, it, aux)
            df_pay = jnp.where(live, out[0] / out[1], 0.0)

            f_curve = factor_at(breakevens, C["tq"], C["infl_times"])
            cpi_b = jnp.where(b_fixed, C["b_val"],
                              C["seas_b"] * C["base_cpi"] * f_curve[0])
            cpi_f = jnp.where(f_fixed, C["f_val"],
                              C["seas_f"] * C["base_cpi"] * f_curve[1])
            infl_payment = C["notional"] * (cpi_f / cpi_b - 1.0)
            return (C["fixed_amt"]
                    + C["infl_sign"] * infl_payment) * df_pay
        return pv_fn

    value, delta, gamma = _risk_package(
        engine, infl_curve,
        ("zcis", it, infl_curve._interp_type, bool(b_fixed), bool(f_fixed),
         bool(live)), make_pv,
        jnp.asarray(ois_curve.swap_rates),
        jnp.asarray(infl_curve.breakeven_rates), consts, reqs, ccy, ois_ct,
        infl_ct, to_tenor(list(ois_curve.swap_times)),
        list(infl_curve.tenors))

    return AnalyticsResult(value=value, risk=delta, gamma=gamma)
