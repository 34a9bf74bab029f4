"""Block-sparse per-trade gamma matrices for the WHOLE book.

A trade's exact gamma lives on its own curves' quote slots: quotes that
cannot move any curve the trade's cashflows gather from have identically
zero second-order effect on its PV. So instead of the dense
[B, N, N] per-trade tensor (terabytes at flagship scale; the reference assembles the same shape one position at a
time, /root/reference/cavour/market/position/engine.py:2563-2568), this
module emits, for EVERY trade, its own-block matrix [k, k] plus the
block's quote-index map, where k = the total quote count of the curves
the trade touches — closed over XCCY parents, so the block is EXACT, not
a truncation (test_pertrade_blocks.py proves the dense complement is 0).

Mechanics:

- base trades are grouped by their touched-curve signature; each group
  compiles ONE jitted program producing [Bg, k, k]:
    term1 (the trade's DF-space Hessian quad form) over the group's
      harvested lin/trip/clamp slots with J restricted to the block's
      quote rows — the same closed-form slot algebra as
      multibook.make_per_trade_gamma_fn, k-wide instead of N-wide;
    term2 (curve-Hessian contraction) via
      structured_risk.make_pertrade_curvehess(restrict=...) — the
      per-stage second-order tensors are computed once and contracted
      with each trade's restricted DF-gradient rows, with untouched
      stages skipped from the traced program entirely.
- the shared curve jacobian J [N, n_grid] (over the compacted
  (curve, time) grid axis) and primal grids come from ONE jitted prep
  program reused by every group.
- groups larger than ``chunk`` base trades split into equal-shape
  sub-blocks (slot tables padded to the max) so each group still
  compiles exactly once.
- lazily tiled books exploit exact notional linearity: per-trade gamma
  of copy c is scale[c] times the base trade's (proven by
  test_multibook_pertrade.py::test_lazy_tile_selection), so the full
  book's blocks are a device-side broadcast of the base blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.error import LibError
from .multibook import MultiBook


@dataclasses.dataclass
class GammaBlockGroup:
    """One signature group's static metadata + (after the call) blocks.

    ``qidx`` maps block coordinates to packed-quote-vector coordinates:
    blocks[b][i, j] is the gamma entry d2 PV_b / dq[qidx[i]] dq[qidx[j]]
    (ccy units per unit-rate^2; multiply by 1e-8 for per-bp^2). Entries
    of the full [N, N] per-trade gamma outside qidx x qidx are exactly
    zero."""
    cids: Tuple[int, ...]            # touched curve ids (sorted)
    qidx: np.ndarray                 # [k] global quote indices
    trade_ids: np.ndarray            # [Bg_total] trade ids (tiled ids)
    blocks: Optional[jnp.ndarray] = None   # [Bg_total, k, k]


def dense_from_block(group: GammaBlockGroup, pos: int, n_quotes: int
                     ) -> np.ndarray:
    """Scatter one trade's block into the dense [N, N] (test/report
    helper; production consumers should stay in block coordinates)."""
    out = np.zeros((n_quotes, n_quotes))
    blk = np.asarray(group.blocks[pos])
    out[np.ix_(group.qidx, group.qidx)] = blk
    return out


def _touched_sets(mb: MultiBook) -> List[set]:
    """Per BASE trade: the set of curve ids its slots gather from,
    closed over XCCY parents (when the basket recalibrates them
    in-graph, quote moves on a parent move the XCCY grid — the block
    must carry those directions)."""
    basket = mb.basket
    CU = basket.n_grid
    curve_of = np.asarray(basket.grid_curve_of, dtype=np.int64)
    agg = mb.aggregate
    B_base = mb.tile.base_trades if mb.tile is not None else mb.n_trades
    touched: List[set] = [set() for _ in range(B_base)]

    trip_cids = np.stack([curve_of[np.asarray(agg.trip_s)],
                          curve_of[np.asarray(agg.trip_e)],
                          curve_of[np.asarray(agg.trip_p)]])

    for cb in mb.cols:
        ci = np.asarray(cb.col_idx)
        w = np.asarray(cb.w)
        rt = np.asarray(cb.row_trade)
        for r in range(ci.shape[0]):
            t = int(rt[r])
            live = w[r] != 0.0
            cols = ci[r][live]
            is_trip = cols >= CU
            for c in cols[~is_trip]:
                touched[t].add(int(curve_of[c]))
            for c in cols[is_trip]:
                ti = int(c) - CU
                touched[t].update(int(x) for x in trip_cids[:, ti])
    if mb.clamp is not None:
        c = mb.clamp
        st = np.asarray(c.slot_trade)
        for r in range(st.shape[0]):
            t = int(st[r])
            touched[t].update((int(curve_of[c.s_idx[r]]),
                               int(curve_of[c.e_idx[r]]),
                               int(curve_of[c.p_idx[r]])))

    if basket.recalibrate_xccy:
        for s in touched:
            for cid in list(s):
                spec = basket.specs[cid]
                if spec.kind == "xccy":
                    s.add(spec.dom_id)
                    s.add(spec.for_id)
    return touched


def _harvest_group(mb: MultiBook, local_of: Dict[int, int]) -> dict:
    """Flat lin/trip/clamp slot tables for one group's base trades
    (b indices LOCAL to the group, weights at base scale)."""
    CU = mb.basket.n_grid
    agg = mb.aggregate
    lin, trip, clamp_sl = [], [], []
    for cb in mb.cols:
        ci = np.asarray(cb.col_idx)
        w = np.asarray(cb.w)
        rt = np.asarray(cb.row_trade)
        for r in range(ci.shape[0]):
            t = int(rt[r])
            if t not in local_of:
                continue
            b = local_of[t]
            live = w[r] != 0.0
            cols = ci[r][live]
            ws = w[r][live]
            is_trip = cols >= CU
            for c, wv in zip(cols[~is_trip], ws[~is_trip]):
                lin.append((b, int(c), float(wv)))
            for c, wv in zip(cols[is_trip], ws[is_trip]):
                ti = int(c) - CU
                trip.append((b, int(agg.trip_s[ti]),
                             int(agg.trip_e[ti]),
                             int(agg.trip_p[ti]), float(wv)))
    if mb.clamp is not None:
        c = mb.clamp
        st = np.asarray(c.slot_trade)
        for r in range(st.shape[0]):
            t = int(st[r])
            if t not in local_of:
                continue
            clamp_sl.append((local_of[t], int(c.s_idx[r]),
                             int(c.e_idx[r]), int(c.p_idx[r]),
                             float(c.ia[r]), float(c.w[r]),
                             float(c.spread[r]), float(c.cap[r]),
                             float(c.floor[r])))
    return dict(
        lin=np.asarray(lin, dtype=np.float64).reshape(-1, 3),
        trip=np.asarray(trip, dtype=np.float64).reshape(-1, 5),
        clamp=np.asarray(clamp_sl, dtype=np.float64).reshape(-1, 9))


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Pad slot tables with dead rows (weight columns 0 -> exact
    zeros everywhere downstream; b/index columns 0 are safe adds)."""
    if a.shape[0] == n:
        return a
    out = np.zeros((n,) + a.shape[1:], dtype=a.dtype)
    out[:a.shape[0]] = a
    return out


def _split_tables(tab: dict, n_sub: int, sizes: List[int]) -> List[dict]:
    """Split a group's tables into n_sub sub-blocks by LOCAL b index
    ranges of equal chunk size, padding each table kind to its max row
    count so every sub-block shares one compiled shape."""
    subs = []
    lo = 0
    for s in sizes:
        hi = lo + s
        sub = {}
        for kind in ("lin", "trip", "clamp"):
            a = tab[kind]
            sel = a[(a[:, 0] >= lo) & (a[:, 0] < hi)].copy()
            sel[:, 0] -= lo
            sub[kind] = sel
        subs.append(sub)
        lo = hi
    for kind in ("lin", "trip", "clamp"):
        n = max(s[kind].shape[0] for s in subs)
        for s in subs:
            s[kind] = _pad_rows(s[kind], n)
    return subs


def _tables_device(sub: dict, mb: MultiBook,
                   row_pos: Dict[int, int]) -> dict:
    """Pack one sub-block's tables as device int/float arrays with both
    GLOBAL (compact) flat-DF indices (for dfs/J gathers) and LOCAL
    restricted-row indices (for the [B, T*U] gradient scatter — the
    restricted grid stays time-DENSE per touched curve, which is the
    layout make_pertrade_curvehess's restrict mode slices)."""
    U = mb.unique_times.shape[0]
    curve_of = np.asarray(mb.basket.grid_curve_of, dtype=np.int64)
    local_of = np.asarray(mb.basket.grid_local_of, dtype=np.int64)
    n_c = (max(row_pos) + 1) if row_pos else 0
    rowpos_arr = np.full(n_c, -1, dtype=np.int64)
    for cid, rp in row_pos.items():
        rowpos_arr[cid] = rp

    def loc(idx):
        idx = idx.astype(np.int64)
        return (rowpos_arr[curve_of[idx]] * U
                + local_of[idx]).astype(np.int32)

    lin, trip, cl = sub["lin"], sub["trip"], sub["clamp"]
    out = dict(
        lin_b=lin[:, 0].astype(np.int32),
        lin_c=lin[:, 1].astype(np.int32),
        lin_cl=loc(lin[:, 1]),
        lin_w=lin[:, 2],
        tr_b=trip[:, 0].astype(np.int32),
        tr_s=trip[:, 1].astype(np.int32),
        tr_e=trip[:, 2].astype(np.int32),
        tr_p=trip[:, 3].astype(np.int32),
        tr_sl=loc(trip[:, 1]),
        tr_el=loc(trip[:, 2]),
        tr_pl=loc(trip[:, 3]),
        tr_w=trip[:, 4],
        cl_b=cl[:, 0].astype(np.int32),
        cl_s=cl[:, 1].astype(np.int32),
        cl_e=cl[:, 2].astype(np.int32),
        cl_p=cl[:, 3].astype(np.int32),
        cl_sl=loc(cl[:, 1]),
        cl_el=loc(cl[:, 2]),
        cl_pl=loc(cl[:, 3]),
        cl_ia=cl[:, 4], cl_w=cl[:, 5], cl_sp=cl[:, 6],
        cl_cap=cl[:, 7], cl_lo=cl[:, 8])
    return out


def _group_specs(mb: MultiBook, chunk: Optional[int]):
    """Per-signature-group static metadata shared by the single-device
    and mesh-sharded block builders. Returns (specs, scale, B_base,
    n_cop); each spec carries cids/qidx/row_pos/trade_ids/Bg, the raw
    harvested slot tables ``tab`` (local b indices 0..Bg), and
    ``make_sub_fn(Bs)`` building the jitted [Bs, k, k] block kernel at
    a caller-chosen batch size. With ``chunk`` set, also the
    chunk-split device tables (``tabs_dev``/``sizes``) the
    single-device sweep dispatches over."""
    basket = mb.basket
    if getattr(basket, "_stages", None) is None:
        raise LibError("per-trade gamma blocks need the batched curve "
                       "topology (compile_multibook batch_curves=True)")
    from .structured_risk import make_pertrade_curvehess

    U = mb.unique_times.shape[0]

    touched = _touched_sets(mb)
    groups_by_sig: Dict[Tuple[int, ...], List[int]] = {}
    for t, s in enumerate(touched):
        if not s:
            continue                     # fully settled: zero gamma
        groups_by_sig.setdefault(tuple(sorted(s)), []).append(t)

    if mb.tile is not None:
        scale = jnp.asarray(mb.tile.scale)
        B_base = mb.tile.base_trades
        n_cop = int(mb.tile.scale.shape[0])
    else:
        scale = jnp.ones(1)
        B_base = mb.n_trades
        n_cop = 1

    group_specs = []
    for cids, base_ids in sorted(groups_by_sig.items()):
        qidx = np.concatenate([
            np.arange(basket.specs[c].offset,
                      basket.specs[c].offset + basket.specs[c].n_quotes)
            for c in cids]).astype(np.int32)
        k = qidx.shape[0]
        row_pos = {cid: i for i, cid in enumerate(cids)}
        Bg = len(base_ids)

        local_of = {t: i for i, t in enumerate(base_ids)}
        tab = _harvest_group(mb, local_of)

        restrict = dict(cids=list(cids), width=k)
        curvehess = make_pertrade_curvehess(basket, restrict=restrict)
        T = len(cids)
        blk_q = jnp.asarray(qidx)

        def _sub_fn(qvec, P, dfs, J, tb, k=k, T=T, blk_q=blk_q,
                    curvehess=curvehess, Bs=None):
            Jb = J[blk_q]                       # [k, C*U]

            # DF-space gradient on the restricted rows [Bs, T*U]
            G = jnp.zeros((Bs, T * U))
            G = G.at[tb["lin_b"], tb["lin_cl"]].add(tb["lin_w"])
            a = dfs[tb["tr_s"]]
            b_ = dfs[tb["tr_e"]]
            c_ = dfs[tb["tr_p"]]
            w = tb["tr_w"]
            G = G.at[tb["tr_b"], tb["tr_sl"]].add(w * c_ / b_)
            G = G.at[tb["tr_b"], tb["tr_el"]].add(
                -w * a * c_ / (b_ * b_))
            G = G.at[tb["tr_b"], tb["tr_pl"]].add(w * (a / b_ - 1.0))

            # term1: slot quad form in block coordinates
            Ja = Jb[:, tb["tr_s"]].T            # [P, k]
            Jbb = Jb[:, tb["tr_e"]].T
            Jc = Jb[:, tb["tr_p"]].T
            f_ab = -c_ / (b_ * b_)
            f_ac = 1.0 / b_
            f_bb = 2.0 * a * c_ / (b_ * b_ * b_)
            f_bc = -a / (b_ * b_)

            def quad(bi, wf, X, Y):
                M = jnp.einsum("p,pn,pm->pnm", wf, X, Y)
                out = jnp.zeros((Bs, k, k))
                return out.at[bi].add(M)

            bi = tb["tr_b"]
            Gm = quad(bi, w * f_ab, Ja, Jbb)
            Gm = Gm + quad(bi, w * f_ac, Ja, Jc)
            Gm = Gm + quad(bi, w * f_bc, Jbb, Jc)
            Gm = Gm + jnp.swapaxes(Gm, 1, 2)
            Gm = Gm + quad(bi, w * f_bb, Jbb, Jbb)

            if tb["cl_b"].shape[0]:
                u = dfs[tb["cl_s"]]
                v = dfs[tb["cl_e"]]
                p = dfs[tb["cl_p"]]
                has = tb["cl_ia"] > 0.0
                ia = jnp.where(has, tb["cl_ia"], 1.0)
                pre = jnp.where(has, (u / v - 1.0) / ia, 0.0) \
                    + tb["cl_sp"]
                rate = jnp.clip(pre, tb["cl_lo"], tb["cl_cap"])
                inside = ((pre > tb["cl_lo"])
                          & (pre < tb["cl_cap"])) & has
                wI = tb["cl_w"] * inside.astype(u.dtype)
                cb_ = tb["cl_b"]
                G = G.at[cb_, tb["cl_pl"]].add(tb["cl_w"] * rate)
                G = G.at[cb_, tb["cl_sl"]].add(wI * p / (ia * v))
                G = G.at[cb_, tb["cl_el"]].add(
                    -wI * p * u / (ia * v * v))
                Ju = Jb[:, tb["cl_s"]].T
                Jv = Jb[:, tb["cl_e"]].T
                Jp = Jb[:, tb["cl_p"]].T
                Gc = quad(cb_, -wI * p / (ia * v * v), Ju, Jv)
                Gc = Gc + quad(cb_, wI / (ia * v), Ju, Jp)
                Gc = Gc + quad(cb_, -wI * u / (ia * v * v), Jv, Jp)
                Gc = Gc + jnp.swapaxes(Gc, 1, 2)
                Gc = Gc + quad(cb_, 2.0 * wI * p * u / (ia * v ** 3),
                               Jv, Jv)
                Gm = Gm + Gc

            # term2: restricted curve-Hessian contraction
            return Gm + curvehess(qvec, P, G)

        def make_sub_fn(Bs, _sub_fn=_sub_fn):
            from functools import partial
            return jax.jit(partial(_sub_fn, Bs=Bs))

        trade_ids = np.asarray(
            [c * B_base + t for c in range(n_cop) for t in base_ids],
            dtype=np.int64)
        spec = dict(cids=tuple(cids), qidx=qidx, trade_ids=trade_ids,
                    row_pos=row_pos, tab=tab, Bg=Bg,
                    make_sub_fn=make_sub_fn)
        if chunk is not None:
            n_sub = -(-Bg // chunk)
            sub_size = -(-Bg // n_sub)
            sizes = [min(sub_size, Bg - i * sub_size)
                     for i in range(n_sub)]
            subs = _split_tables(tab, n_sub, sizes)
            spec["tabs"] = [jax.device_put(_tables_device(s, mb,
                                                          row_pos))
                            for s in subs]
            spec["sizes"] = sizes
            spec["sub_fn"] = make_sub_fn(sub_size)
        group_specs.append(spec)

    return group_specs, scale, B_base, n_cop


def make_per_trade_gamma_blocks_fn(mb: MultiBook, chunk: int = 8192):
    """Build fn(qvec) -> List[GammaBlockGroup] with every trade's exact
    own-block gamma matrix (see module docstring). Requires the batched
    stage topology (compile_multibook's default batch_curves=True)."""
    basket = mb.basket
    grids = basket.grids
    params = jax.device_put(basket.params)

    # shared prep: primal grids + full curve jacobian, one compile
    @jax.jit
    def _prep(qvec, P):
        dfs = grids(qvec, P)
        J = jax.jacfwd(lambda q: grids(q, P))(qvec)      # [C*U, N]
        return dfs, J.T                                   # J as [N, C*U]

    group_specs, scale, B_base, n_cop = _group_specs(mb, chunk)

    def fn(qvec) -> List[GammaBlockGroup]:
        qvec = jnp.asarray(qvec)
        dfs, J = _prep(qvec, params)
        out = []
        for gs in group_specs:
            parts = [gs["sub_fn"](qvec, params, dfs, J, tb)
                     for tb in gs["tabs"]]
            base_blocks = jnp.concatenate(parts)[:gs["Bg"]]
            if n_cop > 1:
                # exact notional linearity across lazy copies
                k = base_blocks.shape[1]
                blocks = (scale[:, None, None, None]
                          * base_blocks[None]).reshape(-1, k, k)
            else:
                blocks = base_blocks
            out.append(GammaBlockGroup(cids=gs["cids"], qidx=gs["qidx"],
                                       trade_ids=gs["trade_ids"],
                                       blocks=blocks))
        return out

    fn.n_groups = len(group_specs)
    fn.group_meta = [(gs["cids"], gs["qidx"].shape[0], gs["Bg"])
                     for gs in group_specs]
    return fn
