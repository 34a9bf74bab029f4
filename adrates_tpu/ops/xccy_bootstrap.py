"""Cross-currency basis-curve bootstrap — pillar-sequential, vectorized.

The reference bootstraps the foreign-in-domestic-collateral curve with a
lax.scan over every payment point, carrying mutable per-point state and an
[n,n] same-swap mask matrix (xccy_curve.py:954-1206). This module solves the
same recurrence in closed form, vectorized:

 - Between par solves, the flat-forward-basis chain
       df_i = df_prev * (df_ois_i / df_ois_prev) * exp(-basis_i * dt_i)
   telescopes to  df_i = C_seg(i) * base_i  with
       base_i = df_ois_i * exp(cumsum(-basis_i * dt_i)),
   one cumulative sum over the whole chain.
 - Each pillar's par condition needs only  PV_known_k = V0_k +
   sum_s C_s * W[k, s]  where W is a tiny [S, S+1] weight matrix
   (einsum over static one-hot masks), so the sequential part collapses
   from n payment points to S pillars — a scan whose carry is the
   [S+1] segment-correction vector (vector-shaped per docs/f64_notes.md;
   per-step scalars are computed on 2-vectors).

Differentiable w.r.t. basis spreads, the foreign OIS discount grid, and
the per-swap domestic-leg PVs, so every jacobian/hessian/cross-hessian the
risk engine needs is one jax transform of this function.

FX convention (unified; the reference contradicts itself between
xccy_curve.py:474, xccy_basis_swap.py:298 and models.py:369): spot_fx is
DOMESTIC per FOREIGN everywhere, and the par condition is
PV_dom + spot_fx * PV_for = 0.
"""

from __future__ import annotations

from typing import NamedTuple

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class XccyBootstrapPlan:
    """Static topology of an XCCY bootstrap (chain points sorted by
    (time, swap index); value-date points excluded from the chain).

    Registered pytree: pass as a jit ARGUMENT, never close over it
    (docs/f64_notes.md rule 6).
    """
    times: np.ndarray            # [n] payment times (ACT/365F curve units)
    pay_t_foreign: np.ndarray    # [n] payment times in foreign-curve units
    start_t: np.ndarray          # [n] accrual starts (foreign-curve units)
    end_t: np.ndarray            # [n] accrual ends
    notionals: np.ndarray        # [n]
    spread_sens: np.ndarray      # [n] year_frac * notional (0 for exchanges)
    alpha_ratio: np.ndarray      # [n] pay_alpha / index_alpha: the leg's
    #   coupon accrual basis over the foreign curve's forward basis (1.0
    #   when they coincide and for exchanges) — the alphas only cancel in
    #   the forward coupon when the leg accrues on the curve's day count
    #   (swap_float_leg.py value(): fwd divides by the INDEX curve basis,
    #   coupons multiply the leg basis)
    dt_chain: np.ndarray         # [n] time since previous chain point
    is_mat: np.ndarray           # [n] bool: pillar maturity point
    is_notl: np.ndarray          # [n] bool: pure notional exchange
    is_last: np.ndarray          # [n] bool: final payment incl. notional
    swap_of: np.ndarray          # [n] int32 parent swap
    seg_of: np.ndarray           # [n] int32 segment (pillars solved before)
    mat_pos: np.ndarray          # [S] int32 chain index of each pillar
    swap_onehot: np.ndarray      # [S, n] live non-maturity points per swap
    seg_onehot: np.ndarray       # [S+1, n]
    v0: np.ndarray               # [S] value-date cashflow sums per swap
    unique_sel: np.ndarray       # [U] int32 first-occurrence node indices
    foreign_sign: float = dataclasses.field(
        default=-1.0, metadata=dict(static=True))  # -1.0 for PAY legs


def bootstrap_xccy(spreads, pv_dom, foreign_times, foreign_dfs, spot_fx,
                   plan: XccyBootstrapPlan, foreign_interp_type=None,
                   foreign_plan=None):
    """Solve the XCCY curve: (times, dfs) with the t=0 node prepended.

    spreads:     [S] pillar basis spreads (decimal)
    pv_dom:      [S] domestic-leg PVs of the calibration swaps
    foreign_*:   the foreign OIS discount grid (times include 0)
    spot_fx:     domestic per foreign
    foreign_interp_type: the foreign curve's own scheme — used so the
        bootstrap's cashflows agree exactly with direct leg valuation under
        EVERY scheme (the reference hardcodes log-linear,
        xccy_curve.py:995-1000, which only matches FLAT_FWD curves).
        None falls back to the reference's log-linear behavior.
    foreign_plan: optional static interp plan
        (ops.interpolation.simple_interp_plan over
        concat(start_t, end_t, pay_t_foreign) x foreign_times) — the
        batched stage path's compile-size control; requires a simple
        foreign scheme.
    """
    spreads = jnp.asarray(spreads)
    pv_dom = jnp.asarray(pv_dom)
    foreign_times = jnp.asarray(foreign_times)
    foreign_dfs = jnp.asarray(foreign_dfs)

    swap_of = jnp.asarray(plan.swap_of)
    notionals = jnp.asarray(plan.notionals)
    is_notl = jnp.asarray(plan.is_notl)
    is_last = jnp.asarray(plan.is_last)
    is_mat = jnp.asarray(plan.is_mat)

    if foreign_plan is not None:
        from .interpolation import simple_df_static
        n = plan.start_t.shape[0]
        out = simple_df_static(foreign_plan, foreign_dfs,
                               foreign_interp_type)
        df_s, df_e, df_pay_ois = out[:n], out[n:2 * n], out[2 * n:]
    elif foreign_interp_type is None:
        log_fdfs = jnp.log(foreign_dfs)
        df_s = jnp.exp(jnp.interp(jnp.asarray(plan.start_t), foreign_times,
                                  log_fdfs))
        df_e = jnp.exp(jnp.interp(jnp.asarray(plan.end_t), foreign_times,
                                  log_fdfs))
        df_pay_ois = jnp.exp(jnp.interp(jnp.asarray(plan.pay_t_foreign),
                                        foreign_times, log_fdfs))
    else:
        from .interpolation import interp_df, interp_fit
        aux = interp_fit(foreign_times, foreign_dfs, foreign_interp_type)
        n = plan.start_t.shape[0]
        q = jnp.concatenate([jnp.asarray(plan.start_t),
                             jnp.asarray(plan.end_t),
                             jnp.asarray(plan.pay_t_foreign)])
        out = interp_df(q, foreign_times, foreign_dfs, foreign_interp_type,
                        aux)
        df_s, df_e, df_pay_ois = out[:n], out[n:2 * n], out[2 * n:]

    # Cashflows: forward coupons (+ final notional) or exchanges. The pay
    # alpha cancels against the forward's divisor only up to the basis
    # ratio (engine parity: xccy_curve.py:1052-1063; the reference assumes
    # the cancellation, which silently mis-calibrates when the leg accrues
    # on a different day count than the foreign curve).
    interest = (df_s / df_e - 1.0) * notionals \
        * jnp.asarray(plan.alpha_ratio) \
        + jnp.where(is_last, notionals, 0.0)
    exchange = jnp.where(is_last, notionals, -notionals)
    cf = jnp.where(is_notl, exchange, interest) \
        + spreads[swap_of] * jnp.asarray(plan.spread_sens)

    # Flat-forward-basis chain, telescoped.
    g = -spreads[swap_of] * jnp.asarray(plan.dt_chain)
    base = df_pay_ois * jnp.exp(jnp.cumsum(g))

    # Per-(swap, segment) weights of known (non-maturity) payments.
    live_w = cf * base
    W = jnp.einsum("ki,i,si->ks", jnp.asarray(plan.swap_onehot), live_w,
                   jnp.asarray(plan.seg_onehot))          # [S, S+1]

    cf_mat = cf[jnp.asarray(plan.mat_pos)]                # [S]
    base_mat = base[jnp.asarray(plan.mat_pos)]            # [S]

    S = spreads.shape[0]
    sign = plan.foreign_sign
    fx = spot_fx

    # The pillar recursion is AFFINE in the chain vector C: each step of
    # the reference's sequential solve is
    #     C[k+1] = -(pvd_k + fxs*(v0_k + W_k . C)) / (fxs*cfm_k*bm_k)
    # and W_k only touches segments <= k (a swap's non-maturity payments
    # precede its own pillar), so x = C[1:] solves the strictly-lower-
    # triangular linear system (I - A) x = b. Solve it by the same
    # Neumann doubling as the OIS pv01 (ops/bootstrap.py): A is nilpotent
    # of index <= S, so ceil(log2(S)) dense [S, S] matmuls replace the
    # S-step sequential scan, and lax.custom_linear_solve makes every
    # jvp/vjp level of the gamma towers ONE extra log-depth solve instead
    # of a differentiated scan.
    fxs = fx * sign
    d = fxs * cf_mat * base_mat                       # [S]
    b_vec = -(pv_dom + fxs * (jnp.asarray(plan.v0) + W[:, 0])) / d
    A = (-(fxs / d))[:, None] * W[:, 1:]              # [S, S] strict lower

    m_steps = max(int(np.ceil(np.log2(max(S, 2)))), 1)

    # Matrix powers hoisted out of the solve closures (see
    # ops/bootstrap.py): one squaring chain per bootstrap invocation,
    # shared by the forward solve and every jvp/vjp/second-order solve;
    # each solve instance is just m_steps matvecs.
    powers = []
    Mk = A
    for k in range(m_steps):
        powers.append(Mk)
        if k + 1 < m_steps:
            Mk = Mk @ Mk
    powers_t = [Mk.T for Mk in powers]

    def _apply_neumann(Ms, bb):
        v = bb
        for Mk in Ms:
            v = v + Mk @ v
        return v

    x = lax.custom_linear_solve(
        lambda v: v - A @ v, b_vec,
        lambda _, bb: _apply_neumann(powers, bb),
        transpose_solve=lambda _, y: _apply_neumann(powers_t, y))

    C_final = jnp.concatenate([jnp.ones(1, dtype=base.dtype), x])
    D = x * base_mat

    # Node DFs: par-solved at pillars, chain values elsewhere.
    mat_rank = jnp.cumsum(is_mat.astype(jnp.int32)) - 1
    df_nodes = jnp.where(is_mat, D[mat_rank.clip(0)],
                         C_final[jnp.asarray(plan.seg_of)] * base)

    sel = jnp.asarray(plan.unique_sel)
    out_times = jnp.asarray(plan.times)[sel]
    out_dfs = df_nodes[sel]
    return (jnp.concatenate([jnp.zeros(1, out_times.dtype), out_times]),
            jnp.concatenate([jnp.ones(1, out_dfs.dtype), out_dfs]))
