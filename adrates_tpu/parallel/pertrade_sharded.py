"""Mesh-sharded per-trade risk ladders.

``make_per_trade_delta_fn`` / ``make_per_trade_gamma_fn`` run on one
device; across several devices the headline aggregates shard
(``make_sharded_multibook_fn``) but per-trade ladders fell back to a
single chip. This module provides the mesh-aware variants:

- ``make_sharded_per_trade_delta_fn``: row slots shard along the mesh's
  book axis (the same placement ``shard_multibook`` uses); every device
  runs the chunked gather-contraction over ITS rows against a REPLICATED
  value jacobian Jv (quote-space-small: [C*U + T, N]), then the
  per-trade partials combine with ONE ``psum_scatter`` so the [B, N]
  ladder emerges SHARDED along trades — no device ever holds the full
  ladder, and the only collective is that single reduce-scatter.
- ``make_sharded_per_trade_gamma_fn``: the trade SELECTION splits across
  devices (embarrassingly parallel — each trade's gamma needs only the
  shared curve jacobian / per-stage second-order tensors, which are
  replicated work); each device computes its [B_loc, N, N] chunk with
  the same closed-form slot algebra + structured curve-Hessian
  contraction as the single-device builder (multibook._sel_gamma_kernel)
  over its own slot tables, out_specs sharded along the selection. Zero
  collectives.
- ``make_sharded_per_trade_gamma_blocks_fn``: the FULL-book block-gamma
  sweep (pertrade_blocks.make_per_trade_gamma_blocks_fn) with each
  signature group's base trades split across the mesh — the one
  per-trade product a desk sweeps daily. Each
  device runs the group's own-block kernel over its trade shard against
  the replicated primal grids / curve jacobian; out_specs shard the
  [Bg, k, k] blocks along trades. Zero collectives.

No reference analogue (the reference loops positions on one CPU,
/root/reference/cavour/market/position/engine.py:2563-2568); this is
the build's own scale-out obligation (SURVEY §7.7).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from .multibook import (ClampSlots, ColRows, MultiBook, _axis_names,
                        _expand_clamp, _expand_cols, _harvest_sel_tables,
                        _pad_clamp, _sel_gamma_kernel)

from jax import shard_map


def _pad_colrows(cb: ColRows, pad: int) -> ColRows:
    """Append ``pad`` dead rows (zero weights -> zero contribution;
    trade 0 receives +0.0)."""
    if pad == 0:
        return cb

    def ext(x):
        xp = jnp if isinstance(x, jnp.ndarray) else np
        return xp.concatenate(
            [x, xp.zeros((pad,) + x.shape[1:], dtype=x.dtype)])

    return ColRows(col_idx=ext(cb.col_idx), w=ext(cb.w),
                   row_trade=ext(cb.row_trade))


def _place_sharded_cols(mb: MultiBook, mesh, axes):
    """Column-form rows + clamp slots placed with their leading axis
    sharded over ``axes`` (lazy TileSpec books expand ON DEVICE straight
    into shards — the full-size host array is never built, matching
    make_sharded_multibook_fn's placement contract)."""
    n_shards = int(np.prod([mesh.shape[a] for a in axes]))
    row2 = NamedSharding(mesh, P(axes, None))
    row1 = NamedSharding(mesh, P(axes))
    col_shard = ColRows(col_idx=row2, w=row2, row_trade=row1)
    cl_shard = ClampSlots(**{
        f.name: row1 for f in dataclasses.fields(ClampSlots)})

    if mb.tile is None:
        cols = tuple(
            ColRows(**{
                f.name: jax.device_put(
                    getattr(c, f.name),
                    row2 if np.asarray(getattr(c, f.name)).ndim == 2
                    else row1)
                for f in dataclasses.fields(ColRows)})
            for c in (_pad_colrows(c, (-c.col_idx.shape[0]) % n_shards)
                      for c in mb.cols))
        clamp = None
        if mb.clamp is not None:
            c = _pad_clamp(mb.clamp, (-mb.clamp.w.shape[0]) % n_shards)
            clamp = ClampSlots(**{
                f.name: jax.device_put(getattr(c, f.name), row1)
                for f in dataclasses.fields(ClampSlots)})
        return cols, clamp, col_shard, cl_shard

    repl = NamedSharding(mesh, P())
    base_cols = jax.device_put(mb.cols, repl)
    base_cl = jax.device_put(mb.clamp, repl) \
        if mb.clamp is not None else None
    tile_dev = jax.device_put(mb.tile, repl)
    out_col = tuple(col_shard for _ in mb.cols)
    out_cl = cl_shard if mb.clamp is not None else None

    @partial(jax.jit, out_shardings=(out_col, out_cl))
    def expand_sharded(cbs, cl, tl):
        ecb = tuple(
            _pad_colrows(ec, (-ec.col_idx.shape[0]) % n_shards)
            for ec in (_expand_cols(c, tl) for c in cbs))
        ecl = None
        if cl is not None:
            ec = _expand_clamp(cl, tl)
            ecl = _pad_clamp(ec, (-ec.w.shape[0]) % n_shards)
        return ecb, ecl

    cols, clamp = expand_sharded(base_cols, base_cl, tile_dev)
    return cols, clamp, col_shard, cl_shard


def make_sharded_per_trade_delta_fn(mb: MultiBook, mesh, axis="book",
                                    chunk: int = 2048, dtype=None):
    """(qvec) -> [B_pad, N] per-trade delta ladders, SHARDED along
    trades over ``mesh``'s ``axis`` (B_pad = n_trades rounded up to the
    shard count; the dead tail rows are exact zeros). Same closed-form
    slot/jacobian split as ``make_per_trade_delta_fn``; each device
    sweeps only its row shard and one psum_scatter assembles the
    ladder. ``fn.n_trades`` carries the live row count."""
    axes = _axis_names(axis)
    n_shards = int(np.prod([mesh.shape[a] for a in axes]))
    repl = NamedSharding(mesh, P())

    basket = mb.basket
    grids = basket.grids
    params = jax.device_put(basket.params, repl)
    agg = jax.device_put(mb.aggregate, repl)
    cols, clamp, col_shard, cl_shard = _place_sharded_cols(mb, mesh, axes)
    n_trades = mb.n_trades
    B_pad = n_trades + (-n_trades) % n_shards
    N = basket.n_quotes

    def _local_sweep(Jv, dfs_flat, cbs, cl):
        """One device's shard of rows -> its [B_pad, N] partial, then
        reduce-scatter along trades."""
        out = jnp.zeros((B_pad, N), Jv.dtype)
        for cb in cbs:
            R = cb.col_idx.shape[0]
            pad = (-R) % chunk

            def padded(x):
                return jnp.concatenate(
                    [x, jnp.zeros((pad,) + x.shape[1:], x.dtype)]) \
                    if pad else x

            stacked = [padded(cb.col_idx), padded(cb.w)]
            stacked = [x.reshape((-1, chunk) + x.shape[1:])
                       for x in stacked]

            def chunk_delta(args):
                ci, wi = args
                # multiply+sum, not einsum: "bp,bpn->bn" lowers to a
                # batch of [1, P] @ [P, N] micro-matmuls
                return jnp.sum(
                    wi.astype(Jv.dtype)[:, :, None] * Jv[ci], axis=1)

            deltas = lax.map(chunk_delta, tuple(stacked))
            deltas = deltas.reshape(-1, N)[:R]
            out = out.at[cb.row_trade].add(deltas)

        if cl is not None:
            df_s = dfs_flat[cl.s_idx]
            df_e = dfs_flat[cl.e_idx]
            df_p = dfs_flat[cl.p_idx]
            ia_safe = jnp.where(cl.ia > 0.0, cl.ia, 1.0)
            fwd = jnp.where(cl.ia > 0.0,
                            (df_s / df_e - 1.0) / ia_safe, 0.0)
            pre = fwd + cl.spread
            rate = jnp.clip(pre, cl.floor, cl.cap)
            inside = ((pre > cl.floor)
                      & (pre < cl.cap)).astype(df_s.dtype)
            cp = cl.w * rate
            cs = cl.w * df_p * inside / (ia_safe * df_e)
            ce = -cl.w * df_p * inside * df_s / (ia_safe * df_e * df_e)
            d = (cp[:, None] * Jv[cl.p_idx] + cs[:, None] * Jv[cl.s_idx]
                 + ce[:, None] * Jv[cl.e_idx])
            out = out.at[cl.slot_trade].add(d.astype(out.dtype))
        return lax.psum_scatter(out, axes, scatter_dimension=0,
                                tiled=True)

    col_specs = tuple(ColRows(col_idx=P(axes, None), w=P(axes, None),
                              row_trade=P(axes)) for _ in cols)
    cl_spec = None if clamp is None else ClampSlots(**{
        f.name: P(axes) for f in dataclasses.fields(ClampSlots)})
    sweep = shard_map(_local_sweep, mesh=mesh,
                      in_specs=(P(), P(), col_specs, cl_spec),
                      out_specs=P(axes, None), check_vma=False)

    @jax.jit
    def _fn(qvec, Pp, cbs, cl, ag):
        dfs_flat = grids(qvec, Pp)
        J = jax.jacfwd(lambda q: grids(q, Pp))(qvec)      # [C*U, N]
        a = dfs_flat[ag.trip_s][:, None]
        b_ = dfs_flat[ag.trip_e][:, None]
        c_ = dfs_flat[ag.trip_p][:, None]
        J_trip = (J[ag.trip_s] * (c_ / b_)
                  - J[ag.trip_e] * (a * c_ / (b_ * b_))
                  + J[ag.trip_p] * (a / b_ - 1.0))
        Jv = jnp.concatenate([J, J_trip])                 # [C*U + T, N]
        if dtype is not None:
            Jv = Jv.astype(dtype)
        return sweep(Jv, dfs_flat, cbs, cl)

    def fn(qvec):
        return _fn(jnp.asarray(qvec), params, cols, clamp, agg)

    fn.n_trades = n_trades
    return fn


def make_sharded_per_trade_gamma_blocks_fn(mb: MultiBook, mesh,
                                           axis="book"):
    """(qvec) -> List[GammaBlockGroup] — every trade's exact own-block
    gamma matrix, with each signature group's base trades SPLIT across
    ``mesh``'s ``axis`` devices (each shard runs the same restricted
    term1 slot algebra + term2 curve-Hessian contraction as
    ``pertrade_blocks.make_per_trade_gamma_blocks_fn`` over its own
    padded slot tables; the [Bg, k, k] result is sharded along trades,
    then the lazy-tile notional broadcast applies as on one device).
    Zero collectives: the primal grids and curve jacobian are one
    replicated prep program, everything per-trade is shard-local."""
    from .pertrade_blocks import (GammaBlockGroup, _group_specs,
                                  _split_tables, _tables_device)

    basket = mb.basket
    axes = _axis_names(axis)
    n_shards = int(np.prod([mesh.shape[a] for a in axes]))
    repl = NamedSharding(mesh, P())
    row_sh = NamedSharding(mesh, P(axes))

    params = jax.device_put(basket.params, repl)
    grids = basket.grids

    @jax.jit
    def _prep(qvec, Pp):
        dfs = grids(qvec, Pp)
        J = jax.jacfwd(lambda q: grids(q, Pp))(qvec)
        return dfs, J.T

    specs, scale, B_base, n_cop = _group_specs(mb, chunk=None)

    sharded_specs = []
    for gs in specs:
        Bg = gs["Bg"]
        B_loc = -(-Bg // n_shards)
        sizes = [max(0, min(B_loc, Bg - i * B_loc))
                 for i in range(n_shards)]
        subs = _split_tables(gs["tab"], n_shards, sizes)
        stacked = {}
        for s in subs:
            dev = _tables_device(s, mb, gs["row_pos"])
            for k_, v in dev.items():
                stacked.setdefault(k_, []).append(v)
        tables = jax.device_put(
            {k_: np.stack(v) for k_, v in stacked.items()}, row_sh)

        sub_fn = gs["make_sub_fn"](B_loc)

        def _body(qvec, Pp, dfs, J, tb, sub_fn=sub_fn):
            tb = {k_: v[0] for k_, v in tb.items()}  # drop shard axis
            return sub_fn(qvec, Pp, dfs, J, tb)

        body = jax.jit(shard_map(
            _body, mesh=mesh,
            in_specs=(P(), P(), P(), P(), P(axes)),
            out_specs=P(axes, None, None), check_vma=False))
        sharded_specs.append(dict(gs, tables=tables, body=body))

    def fn(qvec):
        qvec = jnp.asarray(qvec)
        dfs, J = _prep(qvec, params)
        out = []
        for gs in sharded_specs:
            base_blocks = gs["body"](qvec, params, dfs, J,
                                     gs["tables"])[:gs["Bg"]]
            if n_cop > 1:
                k_ = base_blocks.shape[1]
                blocks = (scale[:, None, None, None]
                          * base_blocks[None]).reshape(-1, k_, k_)
            else:
                blocks = base_blocks
            out.append(GammaBlockGroup(
                cids=gs["cids"], qidx=gs["qidx"],
                trade_ids=gs["trade_ids"], blocks=blocks))
        return out

    fn.n_groups = len(sharded_specs)
    fn.group_meta = [(gs["cids"], gs["qidx"].shape[0], gs["Bg"])
                     for gs in sharded_specs]
    return fn


def make_sharded_per_trade_gamma_fn(mb: MultiBook, mesh, trade_ids,
                                    axis="book"):
    """(qvec) -> [B_sel, N, N] exact selected-trade gamma matrices,
    computed with the selection SPLIT across ``mesh``'s ``axis``
    devices (each runs multibook._sel_gamma_kernel over its own slot
    tables; the result is sharded along the selection). Selections that
    don't divide the shard count are padded by repeating the last trade
    — the pad chunks are dropped before returning."""
    axes = _axis_names(axis)
    n_shards = int(np.prod([mesh.shape[a] for a in axes]))
    repl = NamedSharding(mesh, P())

    sel = np.asarray(trade_ids, dtype=np.int64)
    B_sel = sel.shape[0]
    B_loc = -(-B_sel // n_shards)
    pad = n_shards * B_loc - B_sel
    sel_pad = np.concatenate([sel, np.repeat(sel[-1:], pad)])

    # per-shard tables, padded to common slot counts and stacked on a
    # leading shard axis
    tabs = [_harvest_sel_tables(mb, sel_pad[i * B_loc:(i + 1) * B_loc])
            for i in range(n_shards)]
    stacked: Dict[str, jnp.ndarray] = {}
    for k in tabs[0]:
        # flat slot tables pad along the slot axis (axis 0); the grouped
        # quad-form pair tables gq_* are [B_loc, K] and pad along K.
        # Zero fill is inert either way: zero-weight slots, and gq index
        # 0 points at the grouped layout's dummy zero weight.
        ax = 1 if k.startswith(("gqt_", "gqc_")) else 0
        n = max(t[k].shape[ax] for t in tabs)

        def padk(a, n=n, ax=ax):
            shape = list(a.shape)
            shape[ax] = n
            out = np.zeros(shape, dtype=a.dtype)
            out[tuple(slice(0, s) for s in a.shape)] = a
            return out

        stacked[k] = np.stack([padk(t[k]) for t in tabs])
    tables = jax.device_put(
        stacked, NamedSharding(mesh, P(axes)))

    basket = mb.basket
    params = jax.device_put(basket.params, repl)
    kernel = _sel_gamma_kernel(basket, B_loc)

    def _shard_body(qvec, Pp, tb):
        tb = {k: v[0] for k, v in tb.items()}     # drop the shard axis
        return kernel(qvec, Pp, tb)

    body = shard_map(_shard_body, mesh=mesh,
                     in_specs=(P(), P(), P(axes)),
                     out_specs=P(axes, None, None), check_vma=False)
    _fn = jax.jit(body)

    def fn(qvec):
        out = _fn(jnp.asarray(qvec), params, tables)
        return out[:B_sel] if pad else out

    return fn
