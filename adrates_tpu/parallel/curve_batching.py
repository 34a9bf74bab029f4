"""Batched curve-graph construction: one vmapped bootstrap per GROUP of
same-topology curves instead of one unrolled subgraph per curve.

Why this module exists: the multibook risk programs differentiate the
quotes->grids curve graph once (jacobian) and twice (curve-Hessian
contraction). With 12 curves unrolled the graph is ~3.6k StableHLO ops
and its double-differentiation ~15k, and compile time grows with the op
count. Batching same-shape curves into vmapped group bootstraps cuts the
op count roughly by the group sizes (7 OIS -> 1 vmapped bootstrap, 3
XCCY -> 1, 2 inflation -> 1, 12 interpolation fits -> 1) while keeping
results identical. (On the accelerator this was first built for, the
unrolled S=100 risk program never finished compiling; XLA:GPU's compile
time for either form is not measured yet.)

Padding semantics (all static, built once in numpy):

- Within a group, plans pad to the max point/pillar counts. Padded
  bootstrap rows are arranged to be EXACT no-ops (acc=0, no prev link
  -> pv01=0, df=1; zero-weight chain points for XCCY), so the solves
  return the same pillar DFs as the unbatched path bit-for-bit modulo
  batched-matmul reassociation (~1 ulp).
- Padded grid POSITIONS are then pushed to ascending sentinel times
  t_i = 1e30 + i*1e24 with df 1.0. Interpolating any real query t
  against such a grid reproduces the unpadded clamp extrapolation to
  ~1e-28 relative (the pad knot is 1e30 away), for every simple scheme;
  d(out)/d(pad df) ~ 1e-29, so gradients are clean too.
- PCHIP/cubic curves are NOT batched (a huge pad interval changes the
  fitted tail polynomial); they fall back to per-curve evaluation
  inside the same assembly.

Reference semantics being preserved: OIS bootstrap ois_curve.py:156-212,
XCCY xccy_curve.py:954-1206, inflation factors
inflation_curve.py:246-301 (all /root/reference/cavour).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.bootstrap import OISBootstrapPlan, bootstrap_ois
from ..ops.interpolation import (interp_df, interp_fit, simple_df,
                                 simple_df_static, simple_interp_plan)
from ..ops.pricers import FloatLegTensor, pv_float_leg
from ..ops.xccy_bootstrap import XccyBootstrapPlan, bootstrap_xccy
from ..utils.global_types import InterpTypes

_SIMPLE = (InterpTypes.FLAT_FWD_RATES, InterpTypes.LINEAR_ZERO_RATES,
           InterpTypes.LINEAR_FWD_RATES)


def _sent(i0: int, n: int) -> np.ndarray:
    """Ascending sentinel times for pad positions [i0, i0+n): far beyond
    any real tenor, strictly increasing by position so stacked grids stay
    sorted regardless of which stage padded them."""
    return 1e30 + (i0 + np.arange(n, dtype=np.float64)) * 1e24


def _pad1(a, n, fill):
    a = np.asarray(a)
    out = np.full((n,) + a.shape[1:], fill, dtype=a.dtype)
    out[:a.shape[0]] = a
    return out


def _pad_tail_value(a, n):
    """Pad with the last real value (clamp-safe for interp queries)."""
    a = np.asarray(a, dtype=np.float64)
    out = np.full(n, a[-1] if a.shape[0] else 0.0, dtype=np.float64)
    out[:a.shape[0]] = a
    return out


def _stack_ois_plans(plans: Sequence[OISBootstrapPlan]) -> OISBootstrapPlan:
    """Stack same-loglinear OIS plans into one [G, ...] plan (padded
    rows solve to df=1 and are later sentinelized)."""
    P = max(p.point_times.shape[0] for p in plans)
    Q = max(p.swap_times.shape[0] for p in plans)

    def f(field, pad):
        return np.stack([_pad1(getattr(p, field), P, pad) for p in plans])

    point_times = np.stack([
        np.concatenate([p.point_times,
                        p.point_times[-1] + 1.0
                        + np.arange(P - p.point_times.shape[0])])
        for p in plans])
    swap_times = np.stack([
        np.concatenate([p.swap_times,
                        p.swap_times[-1] + 1.0
                        + np.arange(Q - p.swap_times.shape[0])])
        for p in plans])
    onehot = np.zeros((len(plans), P, P))
    for g, p in enumerate(plans):
        n = p.prev_onehot.shape[0]
        onehot[g, :n, :n] = p.prev_onehot
    kc = max(p.child_idx.shape[1] for p in plans)
    child_idx = np.zeros((len(plans), P, kc), dtype=np.int64)
    child_mask = np.zeros((len(plans), P, kc))
    for g, p in enumerate(plans):
        n, k = p.child_idx.shape
        child_idx[g, :n, :k] = p.child_idx
        child_mask[g, :n, :k] = p.child_mask
    return OISBootstrapPlan(
        point_times=point_times,
        accs=f("accs", 0.0),
        prev_idx=f("prev_idx", -1),
        pillar_idx=f("pillar_idx", -1),
        swap_times=swap_times,
        pillar_point=f("pillar_point", 0),
        prev_onehot=onehot,
        depth=max(p.depth for p in plans),
        loglinear_rates=plans[0].loglinear_rates,
        child_idx=child_idx, child_mask=child_mask,
        # pad rows read rates[0] with weight c=0 — their interp value
        # is unused (acc=0 rows solve to df=1 regardless)
        rate_i0=f("rate_i0", 0), rate_i1=f("rate_i1", 0),
        rate_c=f("rate_c", 0.0))


def _stack_xccy_plans(plans: Sequence[XccyBootstrapPlan]
                      ) -> XccyBootstrapPlan:
    """Stack same-pillar-count XCCY plans: padded chain points carry
    zero cashflow/zero dt (the telescoped chain and the [S, S+1] weight
    matrix are unchanged), padded unique_sel entries duplicate the last
    node and are sentinelized downstream."""
    n = max(p.times.shape[0] for p in plans)
    U = max(p.unique_sel.shape[0] for p in plans)
    S = plans[0].mat_pos.shape[0]

    def f(field, pad, width=n):
        return np.stack([_pad1(getattr(p, field), width, pad)
                         for p in plans])

    def ftail(field):
        return np.stack([_pad_tail_value(getattr(p, field), n)
                         for p in plans])

    sw_oh = np.zeros((len(plans), S, n))
    seg_oh = np.zeros((len(plans), S + 1, n))
    for g, p in enumerate(plans):
        sw_oh[g, :, :p.swap_onehot.shape[1]] = p.swap_onehot
        seg_oh[g, :, :p.seg_onehot.shape[1]] = p.seg_onehot
    uniq = np.stack([
        _pad1(p.unique_sel, U, p.unique_sel[-1]) for p in plans])
    return XccyBootstrapPlan(
        times=ftail("times"),
        pay_t_foreign=ftail("pay_t_foreign"),
        start_t=ftail("start_t"),
        end_t=ftail("end_t"),
        notionals=f("notionals", 0.0),
        spread_sens=f("spread_sens", 0.0),
        alpha_ratio=f("alpha_ratio", 1.0),
        dt_chain=f("dt_chain", 0.0),
        is_mat=f("is_mat", False),
        is_notl=f("is_notl", True),
        is_last=f("is_last", False),
        swap_of=f("swap_of", 0),
        seg_of=f("seg_of", 0),
        mat_pos=np.stack([p.mat_pos for p in plans]),
        swap_onehot=sw_oh,
        seg_onehot=seg_oh,
        v0=np.stack([p.v0 for p in plans]),
        unique_sel=uniq,
        foreign_sign=plans[0].foreign_sign)


def _stack_legs(tensors: Sequence[FloatLegTensor]) -> FloatLegTensor:
    """Stack per-curve [S, P_i] calibration-leg stacks to [G, S, Pmax]
    (same pad fills as multibook._stack_leg_tensors)."""
    P = max(t.payment_times.shape[1] for t in tensors)

    def pad2(a, fill):
        a = np.asarray(a)
        out = np.full((a.shape[0], P), fill, dtype=np.float64)
        out[:, :a.shape[1]] = a
        return out

    def stack(name, fill=0.0):
        return np.stack([pad2(getattr(t, name), fill) for t in tensors])

    def scal(name):
        return np.stack([np.asarray(getattr(t, name), dtype=np.float64)
                         for t in tensors])

    first = tensors[0]
    assert all(t.override_first == first.override_first and
               t.notional_exchange == first.notional_exchange and
               t.has_cap_floor == first.has_cap_floor for t in tensors)
    return FloatLegTensor(
        payment_times=stack("payment_times", -1.0),
        start_times=stack("start_times", 0.0),
        end_times=stack("end_times", 0.0),
        pay_alphas=stack("pay_alphas", 0.0),
        index_alphas=stack("index_alphas", 0.0),
        spreads=stack("spreads", 0.0),
        notionals=stack("notionals", 0.0),
        principal=scal("principal"),
        leg_sign=scal("leg_sign"),
        value_time=scal("value_time"),
        first_fixing_rate=scal("first_fixing_rate"),
        notional_exchange_amount=scal("notional_exchange_amount"),
        effective_time=scal("effective_time"),
        maturity_time=scal("maturity_time"),
        cap_rate=scal("cap_rate"),
        floor_rate=scal("floor_rate"),
        override_first=first.override_first,
        notional_exchange=first.notional_exchange,
        has_cap_floor=first.has_cap_floor)


def _qidx(spec, n: int) -> np.ndarray:
    """Global quote indices for a curve, padded with the LAST real index
    (pad rates repeat the last pillar — monotone under log-interp)."""
    idx = np.arange(spec.offset, spec.offset + spec.n_quotes,
                    dtype=np.int32)
    return _pad1(idx, n, idx[-1])


@dataclasses.dataclass
class _Stage:
    """Static description of one batched stage (arrays live in params)."""
    kind: str                    # 'ois' | 'xccy' | 'infl'
    ids: List[int]               # curve ids in stack order
    key: str                     # params["bat"] entry name
    # xccy only:
    dom_ids: List[int] = None
    for_ids: List[int] = None
    dom_interp: InterpTypes = None
    foreign_interp: InterpTypes = None
    recal: bool = True


# ---------------------------------------------------------------------------
# Stage-native forwards (shared by grids() and the structured risk pass:
# parallel/structured_risk.py differentiates each stage SEPARATELY with a
# per-stage tangent basis, so these must be standalone pure functions)
# ---------------------------------------------------------------------------


def ois_native_ds(rates, b):
    """[G, Qp] padded local rates -> sentinelized native dfs [G, P1].
    (Times are static — b["ts_static"].)"""
    _, ds = jax.vmap(bootstrap_ois, in_axes=(0, 0))(rates, b["plan"])
    return jnp.where(b["pad_mask"], 1.0, ds)


def infl_native_ds(q, b):
    """[G, Qp] breakevens -> sentinelized factor grid [G, Qp+1]."""
    stt = b["swap_times"]
    one = jnp.ones((stt.shape[0], 1), stt.dtype)
    ds = jnp.concatenate([one, jnp.power(1.0 + q, stt)], axis=1)
    return jnp.where(b["pad_mask"], 1.0, ds)


def xccy_legs_pv(dom_ds, b, st: _Stage):
    """Calibration domestic-leg PVs [G, S] from the stacked dom grids —
    the ONLY channel through which the domestic curve reaches the XCCY
    bootstrap (an 8-ish-value bottleneck the structured risk pass
    exploits: dom-quote directions compose through these S values
    instead of re-differentiating the whole stage)."""
    d_it = st.dom_interp
    lp = b.get("legs_plan")
    if lp is not None:
        # static-weight interp (the leg schedules and dom grids are
        # both static) — no searchsorted/knot-matrix in the trace
        def one_curve(dts, dds, lts, ip, dp):
            return jax.vmap(
                lambda lt, i_, d_: pv_float_leg(
                    dds, dts, d_it, lt,
                    plans=dict(idx=i_, disc=d_)))(lts, ip, dp)

        return jax.vmap(one_curve)(b["dom_ts"], dom_ds, b["legs"],
                                   lp["idx"], lp["disc"])

    def one_curve(dts, dds, lts):
        return jax.vmap(
            lambda lt: pv_float_leg(dds, dts, d_it, lt))(lts)

    return jax.vmap(one_curve)(b["dom_ts"], dom_ds, b["legs"])


def xccy_boot_ds(spreads, pv_dom, for_ds, b, st: _Stage):
    """[G, S] spreads + dom-leg PVs + stacked foreign grids ->
    sentinelized native dfs [G, U1]."""
    fp = b.get("fboot_plan")
    if fp is not None:
        _, ds = jax.vmap(
            bootstrap_xccy, in_axes=(0, 0, 0, 0, 0, 0, None, 0))(
                spreads, pv_dom, b["for_ts"], for_ds,
                b["spot_fx"], b["plan"], st.foreign_interp, fp)
    else:
        _, ds = jax.vmap(
            bootstrap_xccy, in_axes=(0, 0, 0, 0, 0, 0, None))(
                spreads, pv_dom, b["for_ts"], for_ds,
                b["spot_fx"], b["plan"], st.foreign_interp)
    return jnp.where(b["pad_mask"], 1.0, ds)


def xccy_native_ds(spreads, dom_ds, for_ds, b, st: _Stage):
    """[G, S] spreads + stacked parent native dfs -> sentinelized native
    dfs [G, U1]. Parent time grids are static (b["dom_ts"]/b["for_ts"])."""
    if st.recal:
        pv_dom = xccy_legs_pv(dom_ds, b, st)
    else:
        pv_dom = b["pv_dom0"]
        for_ds = lax.stop_gradient(for_ds)
    return xccy_boot_ds(spreads, pv_dom, for_ds, b, st)


def stage_rows(ut, ts_static, ds, its: Sequence[InterpTypes],
               plan: Optional[dict] = None):
    """Interpolate a stage's [G, P1] native grids onto the shared query
    times: [G, U]. Same-SIMPLE-scheme members batch through one vmapped
    simple_df; spline members evaluate per curve (identical kernels to
    grids()' cross-stage batching, so values agree bitwise).

    ``plan`` (build_batched_grids' bat[key]["row_plan"]) replaces the
    simple-scheme path with static-weight gathers — the query AND grid
    times are static, so searchsorted + the [U, P1] exact-knot distance
    matrix need not be traced (they multiply through every AD level of
    every stage trace; compile seconds track traced op count)."""
    G = ds.shape[0]
    rows: List = [None] * G
    by_scheme: Dict[InterpTypes, List[int]] = {}
    for m, it in enumerate(its):
        if it in _SIMPLE:
            by_scheme.setdefault(it, []).append(m)
        else:
            t = jnp.asarray(ts_static[m])
            aux = interp_fit(t, ds[m], it)
            q = (jnp.asarray(plan["q"][m])
                 if plan is not None and "q" in plan else ut)
            rows[m] = interp_df(q, t, ds[m], it, aux)
    for it, mids in by_scheme.items():
        if plan is not None and it.name in plan:
            out = jax.vmap(
                lambda p, d, it=it: simple_df_static(p, d, it))(
                    plan[it.name], ds[mids, :])
        else:
            out = jax.vmap(
                lambda t, d, it=it: simple_df(ut, t, d, it))(
                    jnp.asarray(ts_static[np.asarray(mids)]), ds[mids, :])
        for k, m in enumerate(mids):
            rows[m] = out[k]
    return jnp.stack(rows)


def _stack_plans(plans: Sequence[dict]) -> dict:
    """Stack per-member simple_interp_plan dicts along a leading axis."""
    return {k: np.stack([p[k] for p in plans]) for k in plans[0]}


def _row_plan(ut: np.ndarray, ts_static: np.ndarray,
              its: Sequence[InterpTypes]) -> dict:
    """Per-scheme stacked static plans for stage_rows, keyed by scheme
    name in the SAME member grouping stage_rows derives from ``its``."""
    by_scheme: Dict[InterpTypes, List[int]] = {}
    for m, it in enumerate(its):
        if it in _SIMPLE:
            by_scheme.setdefault(it, []).append(m)
    return {it.name: _stack_plans(
        [simple_interp_plan(ut, ts_static[m], it) for m in mids])
        for it, mids in by_scheme.items()}


def build_batched_grids(basket, unique_times: np.ndarray,
                        stage_buckets: str = "fine"):
    """Build the batched quotes->[C*U] grids function for a CurveBasket.

    Returns (grids_fn, bat_params). ``bat_params`` must be merged into
    basket.params under key "bat"; grids_fn(qvec, P) reads P["bat"].

    ``stage_buckets``: "fine" buckets OIS plan shapes at (quotes/8,
    points/32) — minimal tangent padding; "coarse" at (quotes/32,
    points/256) — mixed-pillar-count models (e.g. the flagship's
    32-pillar majors + 12-pillar minors) merge into ONE vmapped OIS
    stage, which removes a whole stage subgraph from EVERY risk-program
    trace (each duplicated stage trace adds compile time) at the price
    of padded per-member tangent directions at runtime.
    """
    if stage_buckets == "coarse":
        qb, pb = 32, 256
    elif stage_buckets == "fine":
        qb, pb = 8, 32
    else:
        raise ValueError(f"stage_buckets must be 'fine' or 'coarse', "
                         f"got {stage_buckets!r}")
    specs = basket.specs
    C = len(specs)
    bat: Dict[str, dict] = {}
    stages: List[_Stage] = []

    # ---- group OIS curves by static solve config --------------------
    ois_ids = [i for i, s in enumerate(specs) if s.kind == "ois"]
    ois_plan_of = {}
    k = 0
    for i, s in enumerate(specs):
        if s.kind == "ois":
            ois_plan_of[i] = basket.params["ois_plans"][k]
            k += 1
    # Group key buckets the plan SHAPES as well as the solve config:
    # one merged group forces every member to the max quote/point count,
    # and the structured risk pass pays one tangent direction per PADDED
    # quote slot — a 12-pillar curve in a 32-pillar group costs 32
    # directions. Shape buckets (quotes to the next multiple of 8,
    # points to the next multiple of 32) keep heterogeneous user models
    # from degrading to per-curve groups while bounding pad waste.
    groups: Dict[tuple, List[int]] = {}
    for i in ois_ids:
        p = ois_plan_of[i]
        key = (p.loglinear_rates,
               -(-p.swap_times.shape[0] // qb),
               -(-p.point_times.shape[0] // pb))
        groups.setdefault(key, []).append(i)
    for gk, ids in groups.items():
        plans = [ois_plan_of[i] for i in ids]
        plan = _stack_ois_plans(plans)
        P1 = plan.point_times.shape[1] + 1      # incl. t=0 node
        pad_mask = np.zeros((len(ids), P1), dtype=bool)
        for g, p in enumerate(plans):
            pad_mask[g, 1 + p.point_times.shape[0]:] = True
        key = f"ois_{len(stages)}"
        sent = np.tile(_sent(0, P1), (len(ids), 1))
        ts_full = np.concatenate(
            [np.zeros((len(ids), 1)), plan.point_times], axis=1)
        ts_static = np.where(pad_mask, sent, ts_full)
        bat[key] = dict(
            plan=plan,
            qidx=np.stack([_qidx(specs[i], plan.swap_times.shape[1])
                           for i in ids]),
            pad_mask=pad_mask,
            sent=sent,
            ts_static=ts_static,
            row_plan=_row_plan(unique_times, ts_static,
                               [specs[i].interp_type for i in ids]))
        stages.append(_Stage(kind="ois", ids=list(ids), key=key))

    # ---- group XCCY curves ------------------------------------------
    xccy_ids = [i for i, s in enumerate(specs) if s.kind == "xccy"]
    xp_of = {}
    k = 0
    for i, s in enumerate(specs):
        if s.kind == "xccy":
            xp_of[i] = basket.params["xccy"][k]
            k += 1
    xgroups: Dict[tuple, List[int]] = {}
    for i in xccy_ids:
        s = specs[i]
        legs = xp_of[i]["dom_legs"]
        xk = (s.foreign_interp_type, specs[s.dom_id].interp_type,
              xp_of[i]["plan"].foreign_sign, s.n_quotes,
              legs.override_first, legs.notional_exchange,
              legs.has_cap_floor, basket.recalibrate_xccy)
        xgroups.setdefault(xk, []).append(i)
    for xk, ids in xgroups.items():
        plans = [xp_of[i]["plan"] for i in ids]
        plan = _stack_xccy_plans(plans)
        U1 = plan.unique_sel.shape[1] + 1       # incl. t=0 node
        pad_mask = np.zeros((len(ids), U1), dtype=bool)
        for g, p in enumerate(plans):
            pad_mask[g, 1 + p.unique_sel.shape[0]:] = True
        key = f"xccy_{len(stages)}"
        sent = np.tile(_sent(0, U1), (len(ids), 1))
        ts_full = np.stack([
            np.concatenate([[0.0], plan.times[g][plan.unique_sel[g]]])
            for g in range(len(ids))])
        ts_static = np.where(pad_mask, sent, ts_full)
        bat[key] = dict(
            plan=plan,
            legs=_stack_legs([xp_of[i]["dom_legs"] for i in ids]),
            spot_fx=np.array([xp_of[i]["spot_fx"] for i in ids]),
            pv_dom0=np.stack([xp_of[i]["pv_dom0"] for i in ids]),
            qidx=np.stack([_qidx(specs[i], specs[i].n_quotes)
                           for i in ids]),
            pad_mask=pad_mask,
            sent=sent,
            ts_static=ts_static,
            row_plan=_row_plan(unique_times, ts_static,
                               [specs[i].interp_type for i in ids]))
        stages.append(_Stage(
            kind="xccy", ids=list(ids), key=key,
            dom_ids=[specs[i].dom_id for i in ids],
            for_ids=[specs[i].for_id for i in ids],
            dom_interp=xk[1], foreign_interp=xk[0],
            recal=basket.recalibrate_xccy))

    # ---- inflation curves (closed form, one group) -------------------
    infl_ids = [i for i, s in enumerate(specs) if s.kind == "infl"]
    if infl_ids:
        sts = []
        k = 0
        by_id = {}
        for i, s in enumerate(specs):
            if s.kind == "infl":
                by_id[i] = basket.params["infl"][k]["swap_times"]
                k += 1
        Q = max(by_id[i].shape[0] for i in infl_ids)
        pad_mask = np.zeros((len(infl_ids), Q + 1), dtype=bool)
        for g, i in enumerate(infl_ids):
            st = np.asarray(by_id[i], dtype=np.float64)
            pad_mask[g, 1 + st.shape[0]:] = True
            sts.append(np.concatenate(
                [st, st[-1] + 1.0 + np.arange(Q - st.shape[0])]))
        sent = np.tile(_sent(0, Q + 1), (len(infl_ids), 1))
        ts_full = np.concatenate(
            [np.zeros((len(infl_ids), 1)), np.stack(sts)], axis=1)
        ts_static = np.where(pad_mask, sent, ts_full)
        bat["infl"] = dict(
            swap_times=np.stack(sts),
            qidx=np.stack([_qidx(specs[i], Q) for i in infl_ids]),
            pad_mask=pad_mask,
            sent=sent,
            ts_static=ts_static,
            row_plan=_row_plan(unique_times, ts_static,
                               [specs[i].interp_type for i in infl_ids]))
        stages.append(_Stage(kind="infl", ids=list(infl_ids), key="infl"))

    # ---- static parent time grids for the XCCY stages (the structured
    # risk pass feeds parent native dfs as explicit stage inputs, so the
    # stacked parent TS must be available as static arrays) -------------
    ts_static_of: Dict[int, np.ndarray] = {}
    for st in stages:
        for g, cid in enumerate(st.ids):
            ts_static_of[cid] = bat[st.key]["ts_static"][g]

    def _stack_static_ts(ids):
        L = max(ts_static_of[i].shape[0] for i in ids)
        return np.stack([
            np.concatenate([ts_static_of[i],
                            _sent(ts_static_of[i].shape[0],
                                  L - ts_static_of[i].shape[0])])
            for i in ids])

    for st in stages:
        if st.kind == "xccy":
            bat[st.key]["dom_ts"] = _stack_static_ts(st.dom_ids)
            bat[st.key]["for_ts"] = _stack_static_ts(st.for_ids)
            b = bat[st.key]
            # static foreign-curve interp plan for the bootstrap's
            # cashflow queries (query times AND the stacked parent
            # grids are static; simple foreign schemes only)
            if st.foreign_interp in _SIMPLE:
                xp = b["plan"]
                b["fboot_plan"] = _stack_plans([
                    simple_interp_plan(
                        np.concatenate([xp.start_t[g], xp.end_t[g],
                                        xp.pay_t_foreign[g]]),
                        b["for_ts"][g], st.foreign_interp)
                    for g in range(len(st.ids))])
            # static interp plans for the calibration domestic legs
            # (pv_float_leg's two interp calls, same query order)
            if st.dom_interp in _SIMPLE:
                legs = b["legs"]
                dts = b["dom_ts"]
                idx_p, disc_p = [], []
                for g in range(len(st.ids)):
                    ip_row, dp_row = [], []
                    for s in range(legs.payment_times.shape[1]):
                        idx_q = np.concatenate(
                            [legs.start_times[g, s],
                             legs.end_times[g, s]])
                        extra = [np.atleast_1d(legs.value_time[g, s])]
                        if legs.notional_exchange:
                            extra.append(np.atleast_1d(
                                legs.effective_time[g, s]))
                            extra.append(np.atleast_1d(
                                legs.maturity_time[g, s]))
                        disc_q = np.concatenate(
                            [legs.payment_times[g, s]] + extra)
                        ip_row.append(simple_interp_plan(
                            idx_q, dts[g], st.dom_interp))
                        dp_row.append(simple_interp_plan(
                            disc_q, dts[g], st.dom_interp))
                    idx_p.append(_stack_plans(ip_row))
                    disc_p.append(_stack_plans(dp_row))
                b["legs_plan"] = dict(
                    idx={k: np.stack([p[k] for p in idx_p])
                         for k in idx_p[0]},
                    disc={k: np.stack([p[k] for p in disc_p])
                          for k in disc_p[0]})

    interp_of = {i: specs[i].interp_type for i in range(C)}

    # static cross-stage interp plans for grids()' final assembly: same
    # scheme grouping and same padded member stacking as _stack_native,
    # so the runtime path is stacked gathers instead of searchsorted
    gplan: Dict[str, dict] = {}
    by_scheme_all: Dict[InterpTypes, List[int]] = {}
    for i in range(C):
        if interp_of[i] in _SIMPLE:
            by_scheme_all.setdefault(interp_of[i], []).append(i)
    for it, ids_ in by_scheme_all.items():
        stacked_ts = _stack_static_ts(ids_)
        gplan[it.name] = _stack_plans([
            simple_interp_plan(unique_times, stacked_ts[g], it)
            for g in range(len(ids_))])
    bat["gplan"] = gplan

    # ---- keep-compact row plans for the structured risk pass ---------
    # A stage's rows only matter at the times the book's index tables
    # reference ON ITS OWN curves (basket.grid_keep_of, the grid
    # compaction): plans built at those queries (padded to the stage
    # max) shrink every [G, U] row/tangent intermediate of the per-stage
    # AD — measured 4.6x dense overhead at flagship_v5 diversity, and
    # the stage row width is what the A/C1/C2 region compiles and HBM
    # scale with. make_pertrade_curvehess keeps the full-U "row_plan"
    # (pertrade_blocks' restricted gradients are time-dense per curve).
    keep_of = getattr(basket, "grid_keep_of", None)
    if keep_of is not None and not getattr(basket, "_grid_dense", True):
        for st in stages:
            qlists = [unique_times[keep_of[cid]] for cid in st.ids]
            Ug = max((len(q) for q in qlists), default=1) or 1
            qpad = np.stack([
                np.concatenate([q, np.full(Ug - len(q),
                                           unique_times[0])])
                for q in qlists])
            plan: Dict[str, np.ndarray] = {"q": qpad}
            by_s: Dict[InterpTypes, List[int]] = {}
            for m, cid in enumerate(st.ids):
                it = interp_of[cid]
                if it in _SIMPLE:
                    by_s.setdefault(it, []).append(m)
            for it, mids in by_s.items():
                plan[it.name] = _stack_plans([
                    simple_interp_plan(qpad[m], ts_static_of[st.ids[m]],
                                       it)
                    for m in mids])
            bat[st.key]["row_plan_keep"] = plan

    def grids(qvec, P):
        # query times come from params, never the closure
        # (docs/f64_notes.md rule 6)
        ut = P["unique_times"]
        B = P["bat"]
        native: Dict[int, tuple] = {}      # id -> (ts, ds) 1-D

        def run_stage(st: _Stage):
            b = B[st.key]
            if st.kind == "ois":
                rates = qvec[b["qidx"]]                       # [G, Q]
                ts, ds = jax.vmap(bootstrap_ois,
                                  in_axes=(0, 0))(rates, b["plan"])
            elif st.kind == "infl":
                q = qvec[b["qidx"]]                           # [G, Q]
                stt = b["swap_times"]
                one = jnp.ones((stt.shape[0], 1), stt.dtype)
                ts = jnp.concatenate([0.0 * one, stt], axis=1)
                ds = jnp.concatenate([one, jnp.power(1.0 + q, stt)],
                                     axis=1)
            else:
                spreads = qvec[b["qidx"]]                     # [G, S]
                dom_ts, dom_ds = _stack_native(st.dom_ids)
                for_ts, for_ds = _stack_native(st.for_ids)
                if st.recal:
                    d_it = st.dom_interp

                    def one_curve(dts, dds, lts):
                        return jax.vmap(
                            lambda lt: pv_float_leg(dds, dts, d_it, lt)
                        )(lts)

                    pv_dom = jax.vmap(one_curve)(dom_ts, dom_ds,
                                                 b["legs"])
                else:
                    pv_dom = b["pv_dom0"]
                    for_ts = lax.stop_gradient(for_ts)
                    for_ds = lax.stop_gradient(for_ds)
                ts, ds = jax.vmap(
                    bootstrap_xccy,
                    in_axes=(0, 0, 0, 0, 0, 0, None))(
                        spreads, pv_dom, for_ts, for_ds,
                        b["spot_fx"], b["plan"], st.foreign_interp)
            # sentinelize pad positions so downstream interpolation
            # clamps at the last REAL knot (to ~1e-28)
            ts = jnp.where(b["pad_mask"], b["sent"], ts)
            ds = jnp.where(b["pad_mask"], 1.0, ds)
            for g, cid in enumerate(st.ids):
                native[cid] = (ts[g], ds[g])

        def _stack_native(ids):
            """Stack per-curve grids to a common padded length."""
            L = max(native[i][0].shape[0] for i in ids)
            tss, dss = [], []
            for i in ids:
                t, d = native[i]
                k = L - t.shape[0]
                if k:
                    t = jnp.concatenate([t, jnp.asarray(
                        _sent(t.shape[0], k))])
                    d = jnp.concatenate([d, jnp.ones(k, d.dtype)])
                tss.append(t)
                dss.append(d)
            return jnp.stack(tss), jnp.stack(dss)

        for st in stages:
            run_stage(st)

        # ---- final interpolation onto the shared grid, batched by
        # scheme (simple schemes only; spline fits stay per-curve) -----
        rows: Dict[int, jnp.ndarray] = {}
        by_scheme: Dict[InterpTypes, List[int]] = {}
        for i in range(C):
            it = interp_of[i]
            if it in _SIMPLE:
                by_scheme.setdefault(it, []).append(i)
            else:
                t, d = native[i]
                aux = interp_fit(t, d, it)
                rows[i] = interp_df(ut, t, d, it, aux)
        gp = B.get("gplan", {})
        for it, ids in by_scheme.items():
            ts, ds = _stack_native(ids)
            if it.name in gp:
                out = jax.vmap(
                    lambda p, d, it=it: simple_df_static(p, d, it))(
                        gp[it.name], ds)
            else:
                out = jax.vmap(
                    lambda t, d, it=it: simple_df(ut, t, d, it))(ts, ds)
            for g, cid in enumerate(ids):
                rows[cid] = out[g]

        return jnp.concatenate([rows[i] for i in range(C)])

    return grids, bat, stages
