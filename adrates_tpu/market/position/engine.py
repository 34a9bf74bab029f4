"""The AD risk engine: PV / delta ladders / gamma matrices / cashflows.

Role parity with /root/reference/cavour/market/position/engine.py (routing
89-124, OIS natural 153-215, fixed/float leg analytics 2498-2576/2808-2934,
bond 505-698, FRN 700-984). The architecture is deliberately different
(accelerator-first):

 - One pure function quotes -> PV per (instrument, curve) pairing; the
   delta ladder is ONE jacrev and the gamma matrix ONE jacfwd∘jacrev of
   that function. The reference assembles grad(pv)(dfs)·J and
   Jᵀ·H_pv·J + Σ grad·H_curve by hand (engine.py:2551-2568) — chain rule
   gives identical numbers, checked in tests to 1e-12.
 - Jitted computations are cached per (curve, tensor-shape) so repricing a
   book of same-shape trades reuses one XLA executable.
 - Engine valuation and direct instrument.value() agree exactly because
   both run on the same bootstrap and interpolation stack (the reference's
   two stacks disagree off-knot).

Unit conventions preserved: delta in ccy/bp (x 1e-4), gamma in ccy/bp^2
(x 1e-8), PAY legs negative.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Set

import jax
import jax.numpy as jnp
import numpy as np

from ...ops.bootstrap import bootstrap_ois
from ...ops.pricers import pv_fixed_leg, pv_float_leg
from ...requests.results import (AnalyticsResult, CashflowItem, Cashflows,
                                 CrossGamma, Delta, Gamma, Risk, Speed,
                                 Valuation)
from ...utils.error import LibError
from ...utils.global_types import (CollateralType, InstrumentTypes,
                                   RequestTypes, SwapTypes,
                                   collateral_to_currency,
                                   get_discount_curve_name)
from ...utils.helpers import to_tenor
from .engine_legacy import LegacyLegAnalytics


class Engine(LegacyLegAnalytics):
    """Routes instruments to pricing kernels and runs the AD risk chain."""

    def __init__(self, model):
        self.model = model
        self._fn_cache: Dict = {}

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------

    def compute(self, derivative, reqs, collateral_type=None
                ) -> AnalyticsResult:
        from ...utils.device_policy import on_request_device
        from ...utils.observability import timed
        reqs = set(reqs)
        dtype = derivative.derivative_type
        with timed("engine.compute", instrument=dtype.name,
                   reqs=len(reqs)), on_request_device():
            return self._compute(derivative, reqs, collateral_type, dtype)

    # Single-measure convenience wrappers (reference engine.py:2150-2243
    # keeps legacy valuation/delta/gamma entry points; here they are thin
    # routes into the same compute path, so every instrument type works).

    def valuation(self, derivative):
        return self.compute(derivative, [RequestTypes.VALUE]).value

    def delta(self, derivative):
        return self.compute(derivative, [RequestTypes.DELTA]).risk

    def gamma(self, derivative):
        return self.compute(derivative, [RequestTypes.GAMMA]).gamma

    def _compute(self, derivative, reqs, collateral_type, dtype
                 ) -> AnalyticsResult:
        if dtype == InstrumentTypes.OIS_SWAP:
            return self._compute_ois(derivative, reqs, collateral_type)
        if dtype == InstrumentTypes.XCCY_SWAP:
            return self._compute_xccy(derivative, reqs)
        if dtype == InstrumentTypes.BOND:
            return self._compute_bond(derivative, reqs)
        if dtype == InstrumentTypes.FRN:
            return self._compute_frn(derivative, reqs)
        if dtype == InstrumentTypes.YOY_INFLATION_SWAP:
            return self._compute_yoy_iis(derivative, reqs)
        if dtype == InstrumentTypes.ZCIS:
            return self._compute_zcis(derivative, reqs)
        raise LibError(f"Unsupported derivative type: {dtype}")

    # ------------------------------------------------------------------
    # shared risk chain
    # ------------------------------------------------------------------

    @staticmethod
    def _curve_jit_cache(curve) -> Dict:
        """Compiled-analytics cache living on the curve: one XLA
        executable per (instrument kind, tensor shapes/flags, requests),
        shared across every trade priced on that curve."""
        cache = getattr(curve, "_jit_cache", None)
        if cache is None:
            cache = {}
            curve._jit_cache = cache
        return cache

    @staticmethod
    def _tensor_signature(tensor) -> tuple:
        if tensor is None:
            return None
        leaves, treedef = jax.tree_util.tree_flatten(tensor)
        return (str(treedef),) + tuple(leaf.shape for leaf in leaves)

    @staticmethod
    def _cached_jit(cache: Dict, key, build):
        """Content-keyed jit cache: ``build()`` constructs the analytics
        function exactly once per key; every later request with the same
        static configuration reuses the compiled executable. This is the
        reference's `_curve_cache` intent
        (/root/reference/cavour/market/position/engine.py:2362-2412) done
        on function identity instead of mutable curve state — and unlike
        the reference's, the key carries the full static configuration, so
        same-shape different-content requests can never collide."""
        fn = cache.get(key)
        if fn is None:
            fn = jax.jit(build())
            cache[key] = fn
        return fn

    @staticmethod
    def _two_curve_analytics(pv_fn, want):
        """Packed analytics for PV(x0, x1, consts): PV, both delta
        ladders, both gamma matrices and the x0-x1 cross-gamma, computed
        in one jitted call and concatenated into one flat vector."""
        def analytics(x0, x1, C):
            parts = []
            if want[0]:
                parts.append(jnp.reshape(pv_fn(x0, x1, C), (1,)))
            if want[1]:
                parts.append(jax.jacrev(pv_fn, argnums=0)(x0, x1, C))
                parts.append(jax.jacrev(pv_fn, argnums=1)(x0, x1, C))
            if want[2]:
                parts.append(jax.jacfwd(jax.jacrev(pv_fn, argnums=0),
                                        argnums=0)(x0, x1, C).ravel())
                parts.append(jax.jacfwd(jax.jacrev(pv_fn, argnums=1),
                                        argnums=1)(x0, x1, C).ravel())
                parts.append(jax.jacfwd(jax.jacrev(pv_fn, argnums=0),
                                        argnums=1)(x0, x1, C).ravel())
            return jnp.concatenate(parts)
        return analytics

    @staticmethod
    def _unpack(packed, sizes):
        """Split one flat device vector into named blocks.

        Engines pack every requested output (PV, ladders, matrices) into a
        SINGLE flat f64 vector on device: each separately-returned array
        is a separate device->host transfer, so a VALUE+DELTA+GAMMA
        request must cost one transfer, not six."""
        packed = np.asarray(packed, dtype=np.float64)
        out = {}
        pos = 0
        for name, shape in sizes:
            n = int(np.prod(shape))
            out[name] = packed[pos:pos + n].reshape(shape)
            pos += n
        return out

    def _swap_analytics(self, curve, fixed_tensor, float_tensor,
                        reqs: Set[RequestTypes]):
        """Compute PV / delta-ladder / gamma-matrix arrays for a
        (fixed leg?, float leg?) pair bootstrapped+discounted on ``curve``.

        The compiled function takes the quote vector and leg tensors as
        arguments, so trades with the same payment count reuse one
        executable. Delta is one jacrev of the quotes->PV map; gamma is
        one jacfwd∘jacrev — the curve-jacobian chain the reference wires
        by hand (engine.py:2551-2568) falls out of the composition.
        """
        plan = curve._plan
        interp_type = curve._interp_type
        want = (RequestTypes.VALUE in reqs, RequestTypes.DELTA in reqs,
                RequestTypes.GAMMA in reqs, RequestTypes.SPEED in reqs)
        if not any(want):  # e.g. CASHFLOWS-only requests
            return {}
        key = ("swap", self._tensor_signature(fixed_tensor),
               self._tensor_signature(float_tensor), want)
        cache = self._curve_jit_cache(curve)
        fn = cache.get(key)
        if fn is None:
            has_fixed = fixed_tensor is not None
            has_float = float_tensor is not None

            # plan/tensors enter as jit ARGUMENTS, never closure
            # constants (docs/f64_notes.md rule 6)
            def analytics(rates, p, ft, lt):
                def pv_fn(r):
                    times, dfs = bootstrap_ois(r, p)
                    pv = 0.0
                    if has_fixed:
                        pv = pv + pv_fixed_leg(dfs, times, interp_type, ft)
                    if has_float:
                        pv = pv + pv_float_leg(dfs, times, interp_type, lt)
                    return pv
                # Pack every output into ONE flat vector: each returned
                # array is a separate device->host transfer.
                parts = []
                if want[0]:
                    parts.append(jnp.reshape(pv_fn(rates), (1,)))
                if want[1]:
                    parts.append(jax.jacrev(pv_fn)(rates))
                if want[2]:
                    parts.append(jax.jacfwd(jax.jacrev(pv_fn))(rates)
                                 .ravel())
                if want[3]:
                    # third order (SPEED): one more forward level over
                    # the gamma tower — the custom_linear_solve bootstrap
                    # keeps every extra AD order O(log depth)
                    # (ops/bootstrap.py). The reference defines the
                    # request type but never implements it.
                    parts.append(jax.jacfwd(jax.jacfwd(
                        jax.jacrev(pv_fn)))(rates).ravel())
                return jnp.concatenate(parts)

            fn = jax.jit(analytics)
            cache[key] = fn
        plan_dev = cache.get("_plan_dev")
        if plan_dev is None:
            plan_dev = jax.device_put(plan)
            cache["_plan_dev"] = plan_dev
        packed = np.asarray(fn(jnp.asarray(curve.swap_rates), plan_dev,
                               fixed_tensor, float_tensor),
                            dtype=np.float64)
        n = len(curve.swap_rates)
        out = {}
        pos = 0
        if want[0]:
            out["pv"] = packed[0]
            pos = 1
        if want[1]:
            out["delta"] = packed[pos:pos + n]
            pos += n
        if want[2]:
            out["gamma"] = packed[pos:pos + n * n].reshape(n, n)
            pos += n * n
        if want[3]:
            out["speed"] = packed[pos:pos + n ** 3].reshape(n, n, n)
        return out

    def _package_outputs(self, raw: Dict, reqs: Set[RequestTypes], currency,
                         curve_type, swap_times) -> Dict:
        out = {}
        if RequestTypes.VALUE in reqs:
            out["value"] = Valuation(amount=float(raw["pv"]),
                                     currency=currency)
        if RequestTypes.DELTA in reqs:
            ladder = np.asarray(raw["delta"], dtype=np.float64) * 1e-4
            out["delta"] = Delta(risk_ladder=ladder,
                                 tenors=to_tenor(list(swap_times)),
                                 currency=currency, curve_type=curve_type)
        if RequestTypes.GAMMA in reqs:
            g = np.asarray(raw["gamma"], dtype=np.float64) * 1e-8
            out["gamma"] = Gamma(risk_ladder=g,
                                 tenors=to_tenor(list(swap_times)),
                                 currency=currency, curve_type=curve_type)
        if RequestTypes.SPEED in reqs and "speed" in raw:
            s = np.asarray(raw["speed"], dtype=np.float64) * 1e-12
            out["speed"] = Speed(risk_cube=s,
                                 tenors=to_tenor(list(swap_times)),
                                 currency=currency, curve_type=curve_type)
        return out

    # ------------------------------------------------------------------
    # OIS
    # ------------------------------------------------------------------

    def _compute_ois(self, derivative, reqs, collateral_type=None
                     ) -> AnalyticsResult:
        if collateral_type is None:
            collateral_ccy = derivative._currency
        else:
            collateral_ccy = collateral_to_currency(collateral_type)
        if collateral_ccy == derivative._currency:
            return self._compute_ois_natural(derivative, reqs)
        return self._compute_ois_xccy_collateral(derivative, reqs,
                                                 collateral_ccy)

    def _compute_ois_natural(self, derivative, reqs) -> AnalyticsResult:
        curve = getattr(self.model.curves, derivative._floating_index.name)
        value_dt = curve._value_dt

        fixed_tensor = derivative._fixed_leg.tensor(value_dt)
        float_tensor = derivative._float_leg.tensor(
            value_dt, index_dc=curve._dc_type)
        raw = self._swap_analytics(curve, fixed_tensor, float_tensor, reqs)
        out = self._package_outputs(raw, reqs, derivative._currency,
                                    derivative._floating_index,
                                    curve.swap_times)

        cashflows = None
        if RequestTypes.CASHFLOWS in reqs:
            cashflows = self._ois_cashflows(derivative, curve)

        return AnalyticsResult(value=out.get("value"),
                               risk=out.get("delta"),
                               gamma=out.get("gamma"),
                               cashflows=cashflows,
                               speed=out.get("speed"))

    def _compute_ois_xccy_collateral(self, derivative, reqs, collateral_ccy
                                     ) -> AnalyticsResult:
        """OIS projected on its natural OIS curve but discounted on the
        {CCY}_{COLL}_XCCY curve, PV converted by spot FX
        (engine.py:217-503)."""
        model = self.model
        ois_curve = getattr(model.curves, derivative._floating_index.name)
        value_dt = ois_curve._value_dt
        disc_name = get_discount_curve_name(derivative._currency,
                                            CollateralType[
                                                collateral_ccy.name])
        if disc_name in model.curves:
            xccy_curve = model.curves[disc_name]
        else:
            # fall back to any XCCY curve whose foreign leg matches
            from ...trades.rates.xccy_curve import XccyCurve
            matches = [c for c in model._curves_dict.values()
                       if isinstance(c, XccyCurve)]
            if len(matches) != 1:
                raise LibError(
                    f"Discount curve {disc_name} not found and no unique "
                    f"XCCY curve to fall back to")
            xccy_curve = matches[0]
        pair = f"{collateral_ccy.name}{derivative._currency.name}"
        spot_fx = model.fx(pair)

        # XccyCurve.df pins ACT/365F for its time conversion, so the
        # discount-side query times must be in that basis (direct-path
        # parity); forwards stay on the natural curve's basis.
        from ...utils.day_count import DayCountTypes
        fixed_tensor = derivative._fixed_leg.tensor(
            value_dt, discount_dc=DayCountTypes.ACT_365F)
        float_tensor = derivative._float_leg.tensor(
            value_dt, index_dc=ois_curve._dc_type,
            discount_dc=DayCountTypes.ACT_365F)

        from ...ops.xccy_bootstrap import bootstrap_xccy
        from .engine_xccy import basis_curve_type

        plan = ois_curve._plan
        it = ois_curve._interp_type
        xccy_it = xccy_curve._interp_type
        want = (RequestTypes.VALUE in reqs, RequestTypes.DELTA in reqs,
                RequestTypes.GAMMA in reqs)

        # The trade's natural OIS curve is usually the XCCY curve's
        # FOREIGN curve (a GBP swap under USD collateral discounts on the
        # GBP-in-USD-collateral curve, whose foreign leg is GBP OIS): the
        # basis bootstrap then consumes the SAME grid the forwards project
        # off, so rate deltas carry the recalibration chain and AD agrees
        # with central FD of a scenario() that rebuilds dependent XCCY
        # curves. When the curves are unrelated the stored foreign grid
        # rides as a constant.
        chain_foreign = xccy_curve._foreign_curve is ois_curve
        f_it = it if chain_foreign \
            else xccy_curve._foreign_curve._interp_type
        n_r = len(ois_curve.swap_rates)
        n_s = len(xccy_curve.basis_spreads)

        key = ("ois_xccy_coll", xccy_it, it, f_it, chain_foreign,
               self._tensor_signature(fixed_tensor),
               self._tensor_signature(float_tensor), n_r, n_s, want)
        cache = self._curve_jit_cache(xccy_curve)

        def build():
            def pv_fn(rates, spreads, C):
                times, dfs = bootstrap_ois(rates, C["plan"])
                if chain_foreign:
                    f_times, f_dfs = times, dfs
                else:
                    f_times, f_dfs = C["for_times"], C["for_dfs"]
                _, xdfs = bootstrap_xccy(
                    spreads, C["pv_dom"], f_times, f_dfs, C["xccy_fx"],
                    C["xccy_plan"], foreign_interp_type=f_it)
                xts = C["xccy_times"]
                pv = pv_fixed_leg(xdfs, xts, xccy_it, C["ft"])
                pv = pv + pv_float_leg(xdfs, xts, xccy_it, C["lt"],
                                       idx_dfs=dfs, idx_times=times,
                                       idx_interp_type=it)
                return (pv / C["fx"])[()]

            def analytics(rates, spreads, C):
                parts = []
                if want[0]:
                    parts.append(jnp.reshape(pv_fn(rates, spreads, C), (1,)))
                if want[1]:
                    parts.append(jax.jacrev(pv_fn, argnums=0)(
                        rates, spreads, C))
                    parts.append(jax.jacrev(pv_fn, argnums=1)(
                        rates, spreads, C))
                if want[2]:
                    parts.append(jax.jacfwd(jax.jacrev(pv_fn, argnums=0),
                                            argnums=0)(
                        rates, spreads, C).ravel())
                    parts.append(jax.jacfwd(jax.jacrev(pv_fn, argnums=1),
                                            argnums=1)(
                        rates, spreads, C).ravel())
                    parts.append(jax.jacfwd(jax.jacrev(pv_fn, argnums=0),
                                            argnums=1)(
                        rates, spreads, C).ravel())
                return jnp.concatenate(parts)
            return analytics

        fn = self._cached_jit(cache, key, build)
        consts = cache.get("_consts_ois_coll")
        if consts is None:
            consts = jax.device_put(dict(
                plan=plan, xccy_plan=xccy_curve._plan,
                xccy_times=jnp.asarray(xccy_curve._times),
                pv_dom=jnp.asarray(xccy_curve._pv_domestic),
                for_times=jnp.asarray(xccy_curve._foreign_curve._times),
                for_dfs=jnp.asarray(xccy_curve._foreign_curve._dfs),
                xccy_fx=jnp.asarray(xccy_curve._spot_fx)))
            cache["_consts_ois_coll"] = consts
        consts = dict(consts, ft=fixed_tensor, lt=float_tensor,
                      fx=jnp.asarray(spot_fx))

        packed = fn(jnp.asarray(ois_curve.swap_rates),
                    jnp.asarray(xccy_curve.basis_spreads), consts)
        sizes = []
        if want[0]:
            sizes.append(("pv", (1,)))
        if want[1]:
            sizes += [("d_ois", (n_r,)), ("d_basis", (n_s,))]
        if want[2]:
            sizes += [("g_ois", (n_r, n_r)), ("g_basis", (n_s, n_s)),
                      ("cross", (n_r, n_s))]
        raw = self._unpack(packed, sizes)

        basis_ct = basis_curve_type(derivative._currency, collateral_ccy)
        ois_tenors = to_tenor(list(ois_curve.swap_times))
        basis_tenors = to_tenor(list(xccy_curve.swap_times))

        value = risk = gamma = None
        if want[0]:
            value = Valuation(float(raw["pv"][0]), collateral_ccy)
        if want[1]:
            risk = Risk([
                Delta(raw["d_ois"] * 1e-4, ois_tenors, collateral_ccy,
                      derivative._floating_index),
                Delta(raw["d_basis"] * 1e-4, basis_tenors, collateral_ccy,
                      basis_ct)])
        if want[2]:
            cross = CrossGamma(
                risk_matrix=raw["cross"] * 1e-8,
                tenors_curve1=ois_tenors, tenors_curve2=basis_tenors,
                currency=collateral_ccy,
                curve_type_1=derivative._floating_index,
                curve_type_2=basis_ct)
            gamma = Risk([
                Gamma(raw["g_ois"] * 1e-8, ois_tenors, collateral_ccy,
                      derivative._floating_index),
                Gamma(raw["g_basis"] * 1e-8, basis_tenors, collateral_ccy,
                      basis_ct)],
                cross_gammas=[cross])
        return AnalyticsResult(value=value, risk=risk, gamma=gamma)

    # ------------------------------------------------------------------
    # cashflow extraction
    # ------------------------------------------------------------------

    def _ois_cashflows(self, derivative, curve) -> Cashflows:
        value_dt = curve._value_dt
        derivative._fixed_leg.value(value_dt, curve)
        derivative._float_leg.value(value_dt, curve, curve)
        pay_fixed = derivative._fixed_leg._leg_type == SwapTypes.PAY
        items = []
        items += self._extract_leg_cashflows(
            derivative._fixed_leg, "Fixed_Pay" if pay_fixed else "Fixed_Rec")
        items += self._extract_leg_cashflows(
            derivative._float_leg, "Float_Rec" if pay_fixed else "Float_Pay")
        return Cashflows(items, derivative._currency)

    @staticmethod
    def _extract_leg_cashflows(leg, leg_type: str):
        items = []
        notionals = getattr(leg, "_notional_array", None) or \
            [leg._notional] * len(leg._payment_dts)
        for i, dt in enumerate(leg._payment_dts):
            rate = leg._rates[i] if hasattr(leg, "_rates") and \
                i < len(leg._rates) else 0.0
            items.append(CashflowItem(
                payment_date=dt,
                notional=float(notionals[i]),
                payment_fraction=float(rate),
                accrual_period=float(leg._year_fracs[i]),
                amount=float(leg._payments[i]),
                discount_factor=float(leg._payment_dfs[i]),
                discounted_amount=float(leg._payment_pvs[i]),
                leg_type=leg_type))
        if getattr(leg, "_notional_exchange", False):
            sign_type = "Notional_Pay" if leg._leg_type == SwapTypes.PAY \
                else "Notional_Rec"
            items.append(CashflowItem(
                payment_date=leg._effective_dt, notional=leg._notional,
                payment_fraction=-1.0, accrual_period=0.0,
                amount=-leg._notional, discount_factor=1.0,
                discounted_amount=-leg._notional, leg_type=sign_type))
            items.append(CashflowItem(
                payment_date=leg._maturity_dt, notional=leg._notional,
                payment_fraction=1.0, accrual_period=0.0,
                amount=leg._notional,
                discount_factor=float(leg._payment_dfs[-1]),
                discounted_amount=float(leg._notional
                                        * leg._payment_dfs[-1]),
                leg_type=sign_type))
        return items

    # ------------------------------------------------------------------
    # placeholders wired in later phases
    # ------------------------------------------------------------------

    def _compute_xccy(self, derivative, reqs) -> AnalyticsResult:
        from .engine_xccy import compute_xccy
        return compute_xccy(self, derivative, reqs)

    def _compute_bond(self, derivative, reqs) -> AnalyticsResult:
        from .engine_credit import compute_bond
        return compute_bond(self, derivative, reqs)

    def _compute_frn(self, derivative, reqs) -> AnalyticsResult:
        from .engine_credit import compute_frn
        return compute_frn(self, derivative, reqs)

    def _compute_yoy_iis(self, derivative, reqs) -> AnalyticsResult:
        from .engine_inflation import compute_yoy_iis
        return compute_yoy_iis(self, derivative, reqs)

    def _compute_zcis(self, derivative, reqs) -> AnalyticsResult:
        from .engine_inflation import compute_zcis
        return compute_zcis(self, derivative, reqs)
