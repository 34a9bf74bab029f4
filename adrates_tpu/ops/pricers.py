"""Leg pricing kernels — pure jitted tensor functions.

Jitted tensor equivalents of the reference engine's JAX pricers
(/root/reference/cavour/market/position/engine.py: _price_fixed_leg_jax at
2414-2448, _float_leg_jax at 2639-2728), with identical masking, first-fixing
override, notional-exchange and sign semantics, generalized to:

 - every interpolation scheme (the reference engine only supports the three
   "simple" schemes; PCHIP/cubic fits here are JAX-native and differentiable)
 - cap/floor clamping of the projected rate (the reference has this only in
   the date-loop FRN path, frn.py:293-298)
 - batch axes via vmap (trades × scenarios) — kernels are written on 1-D
   cashflow tensors and vectorize from the outside.

Everything takes plain arrays so jacrev/hessian/vmap compose freely.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from ..utils.global_types import InterpTypes
from .interpolation import interp_df, simple_df_static


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FixedLegTensor:
    """Compiled fixed leg: static arrays, one row per payment.

    A registered pytree, so it can be passed as a jit ARGUMENT — compiled
    analytics are then shared across all trades with the same shape.
    """
    payment_times: jnp.ndarray   # [P] payment time (years from value date)
    payments: jnp.ndarray        # [P] coupon amounts (alpha * N * c)
    principal: jnp.ndarray       # scalar principal amount paid at maturity
    leg_sign: jnp.ndarray        # +1 receive / -1 pay
    value_time: jnp.ndarray      # scalar time of the valuation date


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FloatLegTensor:
    """Compiled floating leg (pytree; bool switches are static metadata)."""
    payment_times: jnp.ndarray   # [P]
    start_times: jnp.ndarray     # [P] accrual start (projection curve time)
    end_times: jnp.ndarray       # [P] accrual end
    pay_alphas: jnp.ndarray      # [P] payment-basis accrual fractions
    index_alphas: jnp.ndarray    # [P] accrual fractions in the INDEX
    #   curve's day count — the forward divisor. The reference projects
    #   forwards as (df_s/df_e - 1) / yearfrac(index curve dc)
    #   (swap_float_leg.py:229-233, frn.py:139-146) while coupons accrue
    #   on the leg's own basis; when the two day counts differ the alphas
    #   no longer cancel.
    spreads: jnp.ndarray         # [P]
    notionals: jnp.ndarray       # [P]
    principal: jnp.ndarray       # scalar
    leg_sign: jnp.ndarray        # +1 / -1
    value_time: jnp.ndarray      # scalar
    first_fixing_rate: jnp.ndarray   # scalar (0 when unused)
    notional_exchange_amount: jnp.ndarray  # scalar (0 when unused)
    effective_time: jnp.ndarray      # scalar
    maturity_time: jnp.ndarray       # scalar
    cap_rate: jnp.ndarray            # scalar, +inf when unused
    floor_rate: jnp.ndarray          # scalar, -inf when unused
    override_first: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    notional_exchange: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    has_cap_floor: bool = dataclasses.field(
        default=False, metadata=dict(static=True))


def pv_fixed_leg(dfs, times, interp_type: InterpTypes,
                 leg: FixedLegTensor):
    """PV of a fixed leg given a discount grid. Engine parity:
    engine.py:2414-2448 (future-payment mask, relative DFs, principal on
    the final flow, leg sign).

    f64 note: the valuation-time DF is batched into the payment query
    and the principal/sign are folded into the payment vector so no rank-0
    fused chain exists (docs/f64_notes.md rules 1-2).
    """
    n = leg.payment_times.shape[0]
    qt = jnp.concatenate([leg.payment_times,
                          jnp.atleast_1d(leg.value_time)])
    df_all = interp_df(qt, times, dfs, interp_type)
    df_pmts = df_all[:n]
    df_val = df_all[n]

    mask = leg.payment_times > leg.value_time
    last = jnp.arange(n) == n - 1
    amounts = leg.payments + jnp.where(last, leg.principal, 0.0)
    pv = jnp.where(mask, (leg.leg_sign * amounts) * (df_pmts / df_val), 0.0)
    return jnp.sum(pv)


def pv_float_leg(dfs, times, disc_interp_type: InterpTypes,
                 leg: FloatLegTensor,
                 idx_dfs=None, idx_times=None,
                 idx_interp_type: InterpTypes = None,
                 plans: Optional[dict] = None):
    """PV of a floating leg: forwards projected off the index curve,
    discounted on the discount curve. Engine parity: engine.py:2639-2728
    (dual-curve support, 0-accrual guard, first-fixing override on flow 0,
    past-payment mask with >=, optional principal and notional exchanges).

    ``plans``: optional dict(idx=..., disc=...) of static interp plans
    (ops.interpolation.simple_interp_plan over the SAME query orders
    built below) — compile-size control for call sites whose schedule
    and grid times are static (the batched XCCY calibration legs).
    """
    idx_dfs = dfs if idx_dfs is None else idx_dfs
    idx_times = times if idx_times is None else idx_times
    idx_it = disc_interp_type if idx_interp_type is None else idx_interp_type

    n = leg.payment_times.shape[0]

    if plans is not None:
        idx_out = simple_df_static(plans["idx"], idx_dfs, idx_it)
        disc_out = simple_df_static(plans["disc"], dfs, disc_interp_type)
    else:
        # One batched query per curve (no 1-element queries, rule 2,
        # and a single fused searchsorted+gather per curve is the fast
        # path).
        idx_q = jnp.concatenate([leg.start_times, leg.end_times])
        idx_out = interp_df(idx_q, idx_times, idx_dfs, idx_it)

        extra = [jnp.atleast_1d(leg.value_time)]
        if leg.notional_exchange:
            extra.append(jnp.atleast_1d(leg.effective_time))
            extra.append(jnp.atleast_1d(leg.maturity_time))
        disc_q = jnp.concatenate([leg.payment_times] + extra)
        disc_out = interp_df(disc_q, times, dfs, disc_interp_type)
    df_start = idx_out[:n]
    df_end = idx_out[n:]
    df_pmts = disc_out[:n]
    df_val = disc_out[n]

    # double-where guard: the unselected branch must not divide by the
    # padded ia=0 slots — its VJP otherwise computes Inf * 0 = NaN, which
    # surfaces the moment the curve grid becomes a differentiation INPUT
    # (structured_risk feeds parent grids as explicit stage inputs; the
    # NaN landed on the t=0 node's cotangent and poisoned every gamma).
    has_accrual = leg.index_alphas > 0
    ia_safe = jnp.where(has_accrual, leg.index_alphas, 1.0)
    fwd = jnp.where(has_accrual,
                    (df_start / df_end - 1.0) / ia_safe, 0.0)

    if leg.override_first:
        first_mask = jnp.arange(n) == 0
        fwd = jnp.where(first_mask, leg.first_fixing_rate, fwd)

    # Cap/floor clamps the ALL-IN rate (fwd + margin), FRN convention
    # (reference frn.py:293-298).
    rate = fwd + leg.spreads
    if leg.has_cap_floor:
        rate = jnp.clip(rate, leg.floor_rate, leg.cap_rate)

    # Principal rides on the final payment row; everything stays vectorized.
    last = jnp.arange(n) == n - 1
    cf_amounts = rate * leg.pay_alphas * leg.notionals \
        + jnp.where(last, leg.principal, 0.0)

    # Strictly-future coupons only, matching the fixed-leg mask and the
    # direct SwapFloatLeg.value() path (dt > value_dt): a coupon falling
    # exactly on the valuation date has settled. The reference engine used
    # >= here while its direct path used > — an inconsistency, not copied.
    valid = leg.payment_times > leg.value_time
    pv = jnp.where(valid, (leg.leg_sign * cf_amounts) * (df_pmts / df_val),
                   0.0)

    if leg.notional_exchange:
        ex_dfs = disc_out[n + 1:n + 3]
        ex_times = jnp.stack([leg.effective_time, leg.maturity_time])
        ex_amounts = jnp.stack([-leg.notional_exchange_amount,
                                leg.notional_exchange_amount])
        ex_pv = jnp.where(ex_times >= leg.value_time,
                          (leg.leg_sign * ex_amounts) * (ex_dfs / df_val),
                          0.0)
        return jnp.sum(pv) + jnp.sum(ex_pv)

    return jnp.sum(pv)
