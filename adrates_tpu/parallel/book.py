"""Book-scale batched pricing: vmapped trades, scenario grids, mesh sharding.

The reference has no batch dimension anywhere — Portfolio.compute is a
Python loop (portfolio.py:39-66) and scenario() rebuilds a Model per shock
(models.py:507-557). Here the book IS the tensor:

 - at compile time every trade's payment/accrual dates collapse into ONE
   sorted unique-time grid; trades hold int32 indices into it. Pricing a
   whole book is then: one bootstrap, one interpolation over the unique
   grid (O(U), not O(B x P)), and per-trade gathers + fused arithmetic;
 - scenario grids vmap over a shock matrix on top;
 - the trade axis shards over a jax.sharding.Mesh: each device prices its
   slice and portfolio aggregates are all-reduced under GSPMD.

Everything is f64-vector-shaped per docs/f64_notes.md.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.bootstrap import OISBootstrapPlan, bootstrap_ois
from ..ops.interpolation import interp_df, interp_fit
from ..utils.global_types import InterpTypes


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BookTensors:
    """A whole book as padded index/amount arrays. B trades x P slots.

    unique_times [U] is the shared payment/accrual time grid; *_idx arrays
    are int32 indices into it. Padded slots point at index 0 with zero
    amounts and mask=0.
    """
    unique_times: jnp.ndarray        # [U]
    # fixed side
    fix_idx: jnp.ndarray             # [B, P] int32 payment-time index
    fix_payments: jnp.ndarray        # [B, P] signed coupon amounts
    fix_mask: jnp.ndarray            # [B, P] 1.0 live / 0.0 padded-or-past
    # float side
    flt_pay_idx: jnp.ndarray         # [B, P] int32
    flt_start_idx: jnp.ndarray       # [B, P] int32
    flt_end_idx: jnp.ndarray         # [B, P] int32
    flt_pay_alphas: jnp.ndarray      # [B, P]
    flt_index_alphas: jnp.ndarray    # [B, P] forward divisor in the index
    #   curve's day count (== pay_alphas when the bases coincide)
    flt_spreads: jnp.ndarray         # [B, P]
    flt_notionals: jnp.ndarray       # [B, P] signed notionals
    flt_mask: jnp.ndarray            # [B, P]

    @property
    def num_trades(self) -> int:
        return self.fix_idx.shape[0]


class _TimeInterner:
    """Host-side dedupe of payment times into one sorted grid."""

    def __init__(self):
        self._by_key = {}
        self._times = []

    def add(self, t: float) -> int:
        key = round(float(t), 12)
        idx = self._by_key.get(key)
        if idx is None:
            idx = len(self._times)
            self._by_key[key] = idx
            self._times.append(float(t))
        return idx

    def finish(self):
        """Sort the grid, return (times [U], remap old->new)."""
        order = np.argsort(np.asarray(self._times))
        remap = np.empty(len(order), dtype=np.int32)
        remap[order] = np.arange(len(order), dtype=np.int32)
        return np.asarray(self._times)[order], remap


def compile_book(swaps, value_dt, pad_to: Optional[int] = None,
                 index_dc=None) -> BookTensors:
    """Compile a list of OIS products into one indexed BookTensors.

    Only future payments (time > 0) are marked live; pricing assumes the
    curve's anchor (t=0) is the valuation date. ``index_dc`` is the
    projection curve's day count for the forward divisor (defaults to
    each leg's own basis).
    """
    fixed = [s._fixed_leg.tensor(value_dt) for s in swaps]
    flt = [s._float_leg.tensor(value_dt, index_dc=index_dc)
           for s in swaps]
    P_max = pad_to or max(max(t.payment_times.shape[0] for t in fixed),
                          max(t.payment_times.shape[0] for t in flt))

    interner = _TimeInterner()
    interner.add(0.0)  # always include the anchor

    def pad_idx(times):
        t = np.asarray(times)
        idx = np.zeros(P_max, dtype=np.int32)
        for j, tv in enumerate(t):
            idx[j] = interner.add(tv)
        return idx, t.shape[0]

    def pad_val(vec, n=None, fill=0.0):
        v = np.asarray(vec, dtype=np.float64)
        out = np.full(P_max, fill, dtype=np.float64)
        out[:v.shape[0]] = v
        return out

    rows = dict(fix_idx=[], fix_payments=[], fix_mask=[], flt_pay_idx=[],
                flt_start_idx=[], flt_end_idx=[], flt_pay_alphas=[],
                flt_index_alphas=[], flt_spreads=[], flt_notionals=[],
                flt_mask=[])
    for ft, lt in zip(fixed, flt):
        fsign = float(ft.leg_sign)
        lsign = float(lt.leg_sign)

        f_idx, f_n = pad_idx(ft.payment_times)
        mask = np.zeros(P_max)
        mask[:f_n] = (np.asarray(ft.payment_times) > 0.0).astype(float)
        rows["fix_idx"].append(f_idx)
        rows["fix_payments"].append(pad_val(np.asarray(ft.payments) * fsign))
        rows["fix_mask"].append(mask)

        p_idx, p_n = pad_idx(lt.payment_times)
        s_idx, _ = pad_idx(lt.start_times)
        e_idx, _ = pad_idx(lt.end_times)
        # strictly-future coupons, same convention as the fixed mask and
        # pv_float_leg (a payment exactly at the valuation date settled)
        mask = np.zeros(P_max)
        mask[:p_n] = (np.asarray(lt.payment_times) > 0.0).astype(float)
        rows["flt_pay_idx"].append(p_idx)
        rows["flt_start_idx"].append(s_idx)
        rows["flt_end_idx"].append(e_idx)
        rows["flt_pay_alphas"].append(pad_val(lt.pay_alphas))
        rows["flt_index_alphas"].append(pad_val(lt.index_alphas))
        rows["flt_spreads"].append(pad_val(lt.spreads))
        rows["flt_notionals"].append(
            pad_val(np.asarray(lt.notionals) * lsign))
        rows["flt_mask"].append(mask)

    unique_times, remap = interner.finish()
    out = {}
    for k, v in rows.items():
        arr = np.stack(v)
        if k.endswith("_idx") or k in ("fix_idx",):
            arr = remap[arr]
            out[k] = arr.astype(np.int32)
        else:
            out[k] = arr
    # numpy leaves: transferred once at the first jitted call (or pinned
    # explicitly with shard_book / jax.device_put for big books)
    return BookTensors(unique_times=unique_times, **out)


def tile_book(base: BookTensors, n_copies: int, coupon_scale=None,
              notional_scale=None) -> BookTensors:
    """Scale a compiled book up by tiling with per-copy coupon/notional
    multipliers (books share schedules; amounts differ)."""
    if coupon_scale is None:
        coupon_scale = np.ones(n_copies)
    if notional_scale is None:
        notional_scale = np.ones(n_copies)

    def tile(x, scale_vec=None):
        x = np.asarray(x)
        tiled = np.tile(x, (n_copies, 1))
        if scale_vec is not None:
            reps = np.repeat(np.asarray(scale_vec, dtype=np.float64),
                             x.shape[0])
            tiled = tiled * reps[:, None]
        return jnp.asarray(tiled)

    return BookTensors(
        unique_times=base.unique_times,
        fix_idx=tile(base.fix_idx),
        fix_payments=tile(base.fix_payments, coupon_scale),
        fix_mask=tile(base.fix_mask),
        flt_pay_idx=tile(base.flt_pay_idx),
        flt_start_idx=tile(base.flt_start_idx),
        flt_end_idx=tile(base.flt_end_idx),
        flt_pay_alphas=tile(base.flt_pay_alphas),
        flt_index_alphas=tile(base.flt_index_alphas),
        flt_spreads=tile(base.flt_spreads),
        flt_notionals=tile(base.flt_notionals, notional_scale),
        flt_mask=tile(base.flt_mask))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _combine_book(book: BookTensors):
    """Collapse the scenario-invariant per-slot data to three weight
    arrays, so the per-scenario PV pass reads 3 f64 + 4 int32 arrays per
    slot instead of 8 f64 + 4 int32 (the 100-scenario book PV sweep is
    HBM-bandwidth bound):

      pv_b = sum_p w_fix*df[fix] + (w_fwd*(df_s/df_e - 1) + w_spr)*df_pay
    """
    w_fix = book.fix_payments * book.fix_mask
    ia = book.flt_index_alphas
    ratio = jnp.where(ia > 0.0,
                      book.flt_pay_alphas / jnp.where(ia > 0.0, ia, 1.0),
                      0.0)
    w_fwd = ratio * book.flt_notionals * book.flt_mask
    w_spr = book.flt_spreads * book.flt_pay_alphas * book.flt_notionals \
        * book.flt_mask
    return w_fix, w_fwd, w_spr


def _pvs_from_grid(dfs_u, book: BookTensors, combined):
    """Per-trade PVs from an interpolated unique-grid DF vector."""
    w_fix, w_fwd, w_spr = combined
    fix_pv = jnp.sum(w_fix * dfs_u[book.fix_idx], axis=1)
    df_s = dfs_u[book.flt_start_idx]
    df_e = dfs_u[book.flt_end_idx]
    df_p = dfs_u[book.flt_pay_idx]
    cf = w_fwd * (df_s / df_e - 1.0) + w_spr
    return fix_pv + jnp.sum(cf * df_p, axis=1)


def book_pvs(rates, plan: OISBootstrapPlan, interp_type: InterpTypes,
             book: BookTensors, combined=None):
    """Per-trade PVs [B]: one bootstrap, one interpolation over the unique
    grid, per-trade gathers + fused arithmetic."""
    times, dfs = bootstrap_ois(rates, plan)
    aux = interp_fit(times, dfs, interp_type)
    dfs_u = interp_df(book.unique_times, times, dfs, interp_type, aux)
    if combined is None:
        combined = _combine_book(book)
    return _pvs_from_grid(dfs_u, book, combined)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BookAggregate:
    """The book's TOTAL PV collapsed onto the unique-time grid.

    Fixed coupons (and float spread legs) are linear in the discount
    factors: they aggregate to one weight per unique time. Float forward
    terms group by (start, end, pay) index triples:

      total = sum_u w_lin[u] * df[u]
            + sum_t w_trip[t] * (df[s_t]/df[e_t] - 1) * df[p_t]

    U and T are both tiny (hundreds) regardless of book size, so delta
    ladders and gamma matrices of the whole book cost the same as one
    trade's — this is where AD beats the reference's per-trade loop by
    construction, not just by vectorization.
    """
    w_lin: jnp.ndarray       # [U]
    trip_s: jnp.ndarray      # [T] int32
    trip_e: jnp.ndarray      # [T] int32
    trip_p: jnp.ndarray      # [T] int32
    trip_w: jnp.ndarray      # [T]
    unique_times: jnp.ndarray  # [U]


def aggregate_book(book: BookTensors) -> BookAggregate:
    """Collapse a book to its aggregate-PV weights (host-side groupby)."""
    U = int(book.unique_times.shape[0])

    fix_idx = np.asarray(book.fix_idx).ravel()
    fix_w = (np.asarray(book.fix_payments)
             * np.asarray(book.fix_mask)).ravel()
    w_lin = np.bincount(fix_idx, weights=fix_w, minlength=U)

    # float spread component: spread * alpha * notional at the pay index
    flt_pay = np.asarray(book.flt_pay_idx).ravel()
    spread_w = (np.asarray(book.flt_spreads)
                * np.asarray(book.flt_pay_alphas)
                * np.asarray(book.flt_notionals)
                * np.asarray(book.flt_mask)).ravel()
    w_lin += np.bincount(flt_pay, weights=spread_w, minlength=U)

    # float forward component: notional * (df_s/df_e - 1) * df_p
    s = np.asarray(book.flt_start_idx).ravel()
    e = np.asarray(book.flt_end_idx).ravel()
    p = flt_pay
    pa = np.asarray(book.flt_pay_alphas)
    ia = np.asarray(book.flt_index_alphas)
    scale = np.where(ia > 0.0, pa / np.where(ia > 0.0, ia, 1.0), 0.0)
    w = (np.asarray(book.flt_notionals) * scale
         * np.asarray(book.flt_mask)).ravel()
    live = w != 0.0
    key = (s[live].astype(np.int64) * U + e[live]) * U + p[live]
    uniq, inverse = np.unique(key, return_inverse=True)
    trip_w = np.bincount(inverse, weights=w[live])
    trip_p = (uniq % U).astype(np.int32)
    trip_e = ((uniq // U) % U).astype(np.int32)
    trip_s = (uniq // (U * U)).astype(np.int32)

    return BookAggregate(w_lin=jnp.asarray(w_lin),
                         trip_s=jnp.asarray(trip_s),
                         trip_e=jnp.asarray(trip_e),
                         trip_p=jnp.asarray(trip_p),
                         trip_w=jnp.asarray(trip_w),
                         unique_times=book.unique_times)


def aggregate_total_pv(rates, plan: OISBootstrapPlan,
                       interp_type: InterpTypes, agg: BookAggregate):
    """Total book PV from the aggregated weights — O(U + T)."""
    times, dfs = bootstrap_ois(rates, plan)
    aux = interp_fit(times, dfs, interp_type)
    dfs_u = interp_df(agg.unique_times, times, dfs, interp_type, aux)
    lin = jnp.sum(agg.w_lin * dfs_u)
    trip = jnp.sum(agg.trip_w
                   * (dfs_u[agg.trip_s] / dfs_u[agg.trip_e] - 1.0)
                   * dfs_u[agg.trip_p])
    return lin + trip


def book_analytics(rates, plan, interp_type, book, shocks=None):
    """(pvs [S,B], delta [S,N], gamma [S,N,N]) over a scenario shock
    matrix (shocks [S,N] in rate units; None = single base scenario).

    CROSS-CHECK ONLY (not exported): differentiates through the per-trade
    [B, P] gather graph, so each Hessian column costs O(B*P). Production
    paths (`make_book_fn`, `make_multibook_fn`) use the O(U + T)
    aggregate-weight delta/gamma instead; this naive formulation exists to
    validate them in tests."""
    rates = jnp.asarray(rates)
    if shocks is None:
        shocks = jnp.zeros((1, rates.shape[0]))

    def one_scenario(shock):
        r = rates + shock
        pvs = book_pvs(r, plan, interp_type, book)
        total = lambda rr: jnp.sum(book_pvs(rr, plan, interp_type, book))
        delta = jax.jacrev(total)(r)
        gamma = jax.jacfwd(jax.jacrev(total))(r)
        return pvs, delta, gamma

    return jax.vmap(one_scenario)(jnp.asarray(shocks))


def make_book_fn(plan, interp_type, want_gamma: bool = True):
    """Jitted (rates, book, agg, shocks) -> dict of book analytics.

    Per-trade PVs come from the gather kernel; book-level delta/gamma come
    from the aggregated total (identical by construction, tested), so the
    AD graph never differentiates through the [B, P] gathers.
    """

    # plan rides as a jit ARGUMENT (docs/f64_notes.md rule 6); the
    # public signature is
    # unchanged. device_put once so repeat calls don't re-transfer it.
    plan = jax.device_put(plan)

    @jax.jit
    def _fn(rates, p, book, agg, shocks):
        # Per-trade PVs in two phases: all scenario DF grids first (one
        # vmapped bootstrap+interp, [S, U] is tiny), then the [B, P]
        # gather sweep streams scenario-by-scenario (lax.map) so its
        # temporaries exist for ONE scenario at a time — vmapping them
        # across 100 scenarios blows past HBM. The scenario-invariant
        # slot weights are combined ONCE (the sweep is HBM-bound).
        combined = _combine_book(book)

        def grid(shock):
            ts, ds = bootstrap_ois(rates + shock, p)
            aux = interp_fit(ts, ds, interp_type)
            return interp_df(book.unique_times, ts, ds, interp_type, aux)

        dfs_u_all = jax.vmap(grid)(shocks)          # [S, U]
        pvs = lax.map(lambda du: _pvs_from_grid(du, book, combined),
                      dfs_u_all)

        def one_scenario(shock):
            r = rates + shock
            total = lambda rr: aggregate_total_pv(rr, p, interp_type,
                                                  agg)
            out = {"delta": jax.jacrev(total)(r)}
            if want_gamma:
                out["gamma"] = jax.jacfwd(jax.jacrev(total))(r)
            return out

        out = jax.vmap(one_scenario)(shocks)
        out["pvs"] = pvs
        return out

    def fn(rates, book, agg, shocks):
        return _fn(rates, plan, book, agg, shocks)

    return fn


def shard_book(book: BookTensors, mesh: Mesh, axis: str = "book"
               ) -> BookTensors:
    """Place a book with its trade axis sharded across the mesh (the
    shared unique-time grid is replicated)."""
    shard = NamedSharding(mesh, P(axis, None))
    repl = NamedSharding(mesh, P())
    return BookTensors(
        unique_times=jax.device_put(book.unique_times, repl),
        **{f.name: jax.device_put(getattr(book, f.name), shard)
           for f in dataclasses.fields(BookTensors)
           if f.name != "unique_times"})


def make_sharded_book_fn(plan, interp_type, mesh: Mesh,
                         axis: str = "book", want_gamma: bool = True):
    """Book analytics under GSPMD: trades sharded over the mesh, quote
    vector replicated, per-scenario aggregates all-reduced across devices."""
    repl = NamedSharding(mesh, P())

    book_shardings = BookTensors(
        unique_times=repl,
        **{f.name: NamedSharding(mesh, P(axis, None))
           for f in dataclasses.fields(BookTensors)
           if f.name != "unique_times"})

    # plan replicated as an argument (prefix sharding broadcasts over its
    # leaves), never a closure constant (docs/f64_notes.md rule 6).
    plan = jax.device_put(plan, repl)

    @partial(jax.jit, in_shardings=(repl, repl, book_shardings, repl))
    def _fn(rates, p, book, shocks):
        def one_scenario(shock):
            r = rates + shock
            pvs = book_pvs(r, p, interp_type, book)
            total = lambda rr: jnp.sum(
                book_pvs(rr, p, interp_type, book))
            delta = jax.jacrev(total)(r)
            out = {"total_pv": jnp.sum(pvs), "delta": delta}
            if want_gamma:
                out["gamma"] = jax.jacfwd(jax.jacrev(total))(r)
            return out
        return jax.vmap(one_scenario)(shocks)

    def fn(rates, book, shocks):
        return _fn(rates, plan, book, shocks)

    return fn


def make_pershard_aggregate_fn(plan, interp_type, mesh: Mesh,
                               axis: str = "book"):
    """Sharded per-trade PVs + aggregated delta/gamma: the aggregate is
    computed per shard and all-reduced, so the gradient graph stays O(U)
    on every device."""
    repl = NamedSharding(mesh, P())

    plan = jax.device_put(plan, repl)

    @partial(jax.jit, in_shardings=(repl, repl, repl, repl))
    def _fn(rates, p, agg, shocks):
        def one_scenario(shock):
            r = rates + shock
            total = lambda rr: aggregate_total_pv(rr, p, interp_type,
                                                  agg)
            return {"total_pv": total(r),
                    "delta": jax.jacrev(total)(r),
                    "gamma": jax.jacfwd(jax.jacrev(total))(r)}
        return jax.vmap(one_scenario)(shocks)

    def fn(rates, agg, shocks):
        return _fn(rates, plan, agg, shocks)

    return fn


def _slice_book(book: BookTensors, rows: slice, pad: int) -> BookTensors:
    """Row/pad-slice of a compiled book (padded slots sit at the END of
    each row, so truncating the slot axis keeps every live payment)."""
    def cut(x):
        x = np.asarray(x)
        return x[rows, :pad] if x.ndim == 2 else x
    return BookTensors(
        unique_times=book.unique_times,
        **{f.name: cut(getattr(book, f.name))
           for f in dataclasses.fields(BookTensors)
           if f.name != "unique_times"})


def compile_book_buckets(swaps, value_dt, index_dc=None,
                         n_buckets: int = 4):
    """Compile a heterogeneous book into pad-size buckets sharing ONE
    unique-time grid.

    Padding cost is B x P_max per scenario regardless of how many slots
    are live; a book mixing 1Y and 50Y swaps pads every 1Y trade with
    ~49 dead slots. Sorting trades by payment count and padding each
    bucket to its own maximum cuts the (HBM-bandwidth-bound) gather
    sweep traffic by the live/padded ratio.

    Returns (books, order): per-bucket BookTensors and the permutation
    such that concatenated bucket PVs follow swaps[order].
    """
    sizes = np.array([max(len(s._fixed_leg._payment_dts),
                          len(s._float_leg._payment_dts)) for s in swaps])
    order = np.argsort(sizes, kind="stable")
    big = compile_book([swaps[i] for i in order], value_dt,
                       index_dc=index_dc)
    sorted_sizes = sizes[order]
    n = len(swaps)
    # equal-count buckets over the sorted trades; contiguous buckets with
    # the same pad collapse (homogeneous books degrade to one bucket)
    bounds = np.linspace(0, n, min(n_buckets, n) + 1).astype(int)
    spans = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi <= lo:
            continue
        pad = int(sorted_sizes[lo:hi].max())
        if spans and spans[-1][2] == pad:
            spans[-1] = (spans[-1][0], hi, pad)
        else:
            spans.append((lo, hi, pad))
    books = [_slice_book(big, slice(int(lo), int(hi)), pad)
             for lo, hi, pad in spans]
    return books, order


def make_bucketed_book_fn(plan, interp_type, want_gamma: bool = True):
    """make_book_fn over a tuple of pad-bucketed books: per-trade PVs are
    concatenated in bucket order; delta/gamma come from the aggregate."""
    plan = jax.device_put(plan)

    @jax.jit
    def _fn(rates, p, books, agg, shocks):
        def grid(shock):
            ts, ds = bootstrap_ois(rates + shock, p)
            aux = interp_fit(ts, ds, interp_type)
            return interp_df(books[0].unique_times, ts, ds, interp_type,
                             aux)

        dfs_u_all = jax.vmap(grid)(shocks)          # [S, U]
        combos = [_combine_book(b) for b in books]
        pvs = lax.map(
            lambda du: jnp.concatenate(
                [_pvs_from_grid(du, b, c) for b, c in zip(books, combos)]),
            dfs_u_all)

        def one_scenario(shock):
            r = rates + shock
            total = lambda rr: aggregate_total_pv(rr, p, interp_type, agg)
            out = {"delta": jax.jacrev(total)(r)}
            if want_gamma:
                out["gamma"] = jax.jacfwd(jax.jacrev(total))(r)
            return out

        out = jax.vmap(one_scenario)(shocks)
        out["pvs"] = pvs
        return out

    def fn(rates, books, agg, shocks):
        return _fn(rates, plan, tuple(books), agg, shocks)

    return fn


def merge_aggregates(aggs):
    """Sum BookAggregates sharing one unique grid: linear weights add,
    forward triples concatenate with (s, e, p)-key deduplication."""
    U = int(aggs[0].unique_times.shape[0])
    w_lin = np.sum([np.asarray(a.w_lin) for a in aggs], axis=0)
    s = np.concatenate([np.asarray(a.trip_s) for a in aggs])
    e = np.concatenate([np.asarray(a.trip_e) for a in aggs])
    p = np.concatenate([np.asarray(a.trip_p) for a in aggs])
    w = np.concatenate([np.asarray(a.trip_w) for a in aggs])
    key = (s.astype(np.int64) * U + e) * U + p
    uniq, inverse = np.unique(key, return_inverse=True)
    trip_w = np.bincount(inverse, weights=w)
    return BookAggregate(
        w_lin=jnp.asarray(w_lin),
        trip_s=jnp.asarray((uniq // (U * U)).astype(np.int32)),
        trip_e=jnp.asarray(((uniq // U) % U).astype(np.int32)),
        trip_p=jnp.asarray((uniq % U).astype(np.int32)),
        trip_w=jnp.asarray(trip_w),
        unique_times=aggs[0].unique_times)
