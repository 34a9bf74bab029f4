"""Structured scenario risk: per-stage differentiation of the curve graph.

The generic closed-form split (multibook._scenario_risk) pushes N (=every
quote on every curve) tangents through the WHOLE curve graph twice per
scenario: once for the jacobian J = d dfs_flat/dq, once for the
curve-Hessian contraction jacfwd(grad(g0 . dfs)). But the quotes->curves
dependency is BLOCK SPARSE: an OIS or inflation curve depends only on its
own pillar quotes, and an XCCY curve on its basis spreads plus its two
parent OIS curves' quotes. On the flagship book that is <= 72 of 184
quotes per curve — the generic pass wastes ~2.5x the tangent work and,
worse, pushes every tangent through every bootstrap.

This module differentiates each batched STAGE separately with a tangent
basis sized to the stage's parent set and composes by the chain rule:

- J rows, OIS/inflation stage: Qp tangent seeds (one per LOCAL quote
  slot). One seed carries the same unit direction for EVERY group member
  at once — members never interact inside a vmapped stage, so the [Qp]
  basis recovers all G members' jacobians in one sweep (NOT G*Qp seeds).
- J rows, XCCY stage: D = S + Qp_dom + Qp_for COMPOSED directions: basis
  units plus parent jacobian columns (from the parent stage's jvp) fed as
  input tangents of the small xccy stage graph. This evaluates
  J_x = [dF/db, dF/d(ds_dom) . J_dom, dF/d(ds_for) . J_for] without ever
  differentiating the parent bootstraps again.
- term2 = sum_k g_k d2 dfs_k/dq2, by the second-order chain rule:
    XCCY stage: the hessian over the composed directions of
      s(Z) = sum_m g_m . rows_m(spreads + Z_b, dom_ds + J_dom Z_d,
                                for_ds + J_for Z_f)
    is exactly J_in' H_s J_in — no [native x native] H_s is ever
    materialized. The remaining chain term sum_l (ds/d nat_l) H_nat_l
    becomes a COTANGENT v on each parent's native dfs, accumulated and
    folded into the parent stage's scalar:
    OIS stage: hessian of psi(q_c) = g_c . rows_c(q_c) + v_c . ds_c(q_c),
    again with the Qp-direction group trick.

All block placements are static contiguous slice updates (each member's
direction list is a handful of contiguous quote ranges), never f64
scatters or one-hot matmuls (matrix flops spent on pure data
movement). The trip quad form (term1) reuses
multibook._gamma_quad_form on the assembled J.

Reference shape being matched: the same J'HJ + sum grad.H_curve split the
reference assembles per trade (/root/reference/cavour/market/position/
engine.py:2563-2568), here at whole-book x whole-curve-set scale with
the curve-level chain rule exposed.
"""

from __future__ import annotations

from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from .curve_batching import (infl_native_ds, ois_native_ds, stage_rows,
                             xccy_boot_ds, xccy_legs_pv, xccy_native_ds)
from .multibook import (_gamma_quad_form, _gamma_quad_form_grouped,
                        _term1_trip_groups, aggregate_total)


def _build_meta(basket):
    """Static stage metadata shared by the scenario-risk and per-trade
    builders: member positions, per-member quote segments, direction
    metadata for XCCY stages, and the slice-based placement helpers."""
    stages = basket._stages
    specs = basket.specs
    C = len(specs)
    N = basket.n_quotes
    U = int(np.asarray(basket.params["unique_times"]).shape[0])
    bat0 = basket.params["bat"]

    pos_of: Dict[int, tuple] = {}
    for si, st in enumerate(stages):
        for mi, cid in enumerate(st.ids):
            pos_of[cid] = (si, mi)

    its_of = [[specs[i].interp_type for i in st.ids] for st in stages]

    xmeta: Dict[int, dict] = {}
    for si, st in enumerate(stages):
        qidx = np.asarray(bat0[st.key]["qidx"])
        G, S = qidx.shape
        if st.kind != "xccy":
            continue
        if not st.recal:
            # parents are stop-gradient'd: directions = basis only
            xmeta[si] = dict(D=S, S=S, parents=None)
            continue
        parents = []
        D = 0
        for mi in range(G):
            sd, md = pos_of[st.dom_ids[mi]]
            sf, mf = pos_of[st.for_ids[mi]]
            qd = np.asarray(bat0[stages[sd].key]["qidx"])[md]
            qf = np.asarray(bat0[stages[sf].key]["qidx"])[mf]
            p1d = bat0[stages[sd].key]["ts_static"].shape[1]
            p1f = bat0[stages[sf].key]["ts_static"].shape[1]
            parents.append(dict(sd=sd, md=md, qd=qd, p1d=p1d,
                                sf=sf, mf=mf, qf=qf, p1f=p1f))
            D = max(D, S + qd.shape[0] + qf.shape[0])
        xmeta[si] = dict(D=D, S=S, parents=parents)

    def segments(si, mi):
        """[(global_offset, n_live, dir_lo, n_dirs_with_pads)] — local
        dirs [dir_lo, dir_lo+n_dirs) map onto quote rows
        [global_offset, global_offset+n_live), rows beyond n_live being
        group-pad duplicates of the last."""
        st = stages[si]
        qidx = np.asarray(bat0[st.key]["qidx"])
        cid = st.ids[mi]
        segs = [(specs[cid].offset, specs[cid].n_quotes, 0,
                 qidx.shape[1])]
        if st.kind == "xccy" and xmeta[si]["parents"] is not None:
            p = xmeta[si]["parents"][mi]
            lo = qidx.shape[1]
            for sp, mp in ((p["sd"], p["md"]), (p["sf"], p["mf"])):
                par_cid = stages[sp].ids[mp]
                n_dirs = np.asarray(
                    bat0[stages[sp].key]["qidx"]).shape[1]
                segs.append((specs[par_cid].offset,
                             specs[par_cid].n_quotes, lo, n_dirs))
                lo += n_dirs
        return segs

    def fold_pads(seg, n_live, axis):
        """Fold pad-duplicate rows/cols (beyond n_live) into the last
        live one — slices and concats only: .at[i].add would lower to an
        XLA scatter."""
        if seg.shape[axis] <= n_live:
            return seg
        live = jax.lax.slice_in_dim(seg, 0, n_live - 1, axis=axis)
        last = jax.lax.slice_in_dim(seg, n_live - 1, n_live, axis=axis)
        pads = jax.lax.slice_in_dim(seg, n_live, seg.shape[axis],
                                    axis=axis)
        last = last + jnp.sum(pads, axis=axis, keepdims=True)
        return jnp.concatenate([live, last], axis=axis)

    def place_rows(block_rows, segs, width):
        """[Dirs, width] local-direction rows -> [N, width] placement
        via contiguous dynamic_update_slice (never one-hot matmuls or
        scatters)."""
        out = jnp.zeros((N, width), block_rows.dtype)
        for off, n_live, lo, n_dirs in segs:
            seg = fold_pads(block_rows[lo:lo + n_dirs], n_live, 0)
            out = jax.lax.dynamic_update_slice(out, seg, (off, 0))
        return out

    def place_hess(H2, Hm, segs):
        """Add a member's [D, D] local hessian into the global [.., N, N]
        at its segment-pair blocks (slice + add + dynamic_update_slice).
        Supports a leading batch axis on H2/Hm."""
        lead = H2.ndim - 2
        for off1, n1, lo1, nd1 in segs:
            for off2, n2, lo2, nd2 in segs:
                sub = Hm[..., lo1:lo1 + nd1, lo2:lo2 + nd2]
                sub = fold_pads(sub, n1, lead)
                sub = fold_pads(sub, n2, lead + 1)
                start = (0,) * lead + (off1, off2)
                size = H2.shape[:lead] + (n1, n2)
                cur = jax.lax.dynamic_slice(H2, start, size)
                H2 = jax.lax.dynamic_update_slice(H2, cur + sub, start)
        return H2

    # grid-axis compaction metadata (multibook.compile_multibook keeps
    # only the referenced (curve, time) pairs of the dense [C*U] axis;
    # identity when the basket was built without a selection).
    # ``keeprows``: every stage carries a keep-compact row plan
    # (curve_batching "row_plan_keep"), so the structured pass can
    # evaluate stage rows ONLY at each curve's referenced times —
    # compact end-to-end, no dense [G, U] intermediates anywhere.
    dense = getattr(basket, "grid_sel", None) is None \
        or getattr(basket, "_grid_dense", True)
    keeprows = (not dense) and all(
        "row_plan_keep" in bat0[st.key] for st in stages)
    grid = dict(
        dense=dense,
        keeprows=keeprows,
        n_grid=basket.n_grid if not dense else C * U,
        keep_of=(None if dense else basket.grid_keep_of),
        offsets=(None if dense else basket.grid_offsets),
        inv=(None if dense else basket.grid_inv))

    return dict(stages=stages, specs=specs, C=C, N=N, U=U, bat0=bat0,
                pos_of=pos_of, its_of=its_of, xmeta=xmeta,
                segments=segments, fold_pads=fold_pads,
                place_rows=place_rows, place_hess=place_hess, grid=grid,
                ois_first=[si for si, st in enumerate(stages)
                           if st.kind != "xccy"],
                xccy_last=[si for si, st in enumerate(stages)
                           if st.kind == "xccy"])


def make_structured_parts(basket, host_agg=None):
    """Build the structured risk pass as THREE separable functions, so a
    caller can either compose them under one jit (make_structured_risk)
    or compile them as independent region programs
    (multibook.make_staged_multibook_fn, whose region programs can
    precompile concurrently where the monolith compiles as one):

    - ``fwd_delta(qvec, P, agg, clamp_agg)`` -> dict(dfs [n_grid],
      g [n_grid], J [N, n_grid], delta [N], carry): stage forwards,
      per-stage jacobian rows, assembled J (on the compacted grid
      axis), aggregate gradient and the book delta.
      ``carry`` holds exactly the cross-boundary arrays term2 needs
      (per XCCY stage: the stacked parent grids as values, the
      calibration-leg PVs and the composed direction tables) so term2
      never re-differentiates the parent bootstraps.
    - ``term1(J, dfs, agg, clamp_agg)`` -> [N, N]: the trip-table quad
      form J' H_agg J (multibook._gamma_quad_form).
    - ``term2(qvec, P, g, carry)`` -> [N, N]: the per-stage
      curve-Hessian contraction sum_k g_k d2 dfs_k/dq2, XCCY stages
      first (their cotangents fold into the parent OIS stage scalars).

    gamma = term1 + term2, exactly as in the monolithic composition —
    the split only moves the jit cut points; every placement and
    chain-rule composition is unchanged.
    """
    meta = _build_meta(basket)
    stages = meta["stages"]
    C, N, U = meta["C"], meta["N"], meta["U"]
    pos_of = meta["pos_of"]
    its_of = meta["its_of"]
    xmeta = meta["xmeta"]
    _segments = meta["segments"]
    _place_rows = meta["place_rows"]
    _place_hess = meta["place_hess"]
    ois_first = meta["ois_first"]
    xccy_last = meta["xccy_last"]
    grid = meta["grid"]
    keep_of = grid["keep_of"]
    keeprows = grid["keeprows"]
    bat0 = meta["bat0"]
    Uc_of = (None if keep_of is None
             else [int(k.shape[0]) for k in keep_of])
    offs = grid["offsets"]

    def _rp(b):
        """The stage row plan the scenario pass traces: keep-compact
        when available (rows only at each curve's referenced times —
        the [G, U] stage intermediates set the A/C1/C2 regions' memory
        and compile size), else the full-U static plan."""
        return (b.get("row_plan_keep") if keeprows
                else b.get("row_plan"))

    def _crop(x, cid):
        """A member's stage-row output restricted to its curve's
        referenced times (last axis). keeprows: the row WAS evaluated
        at keep times (padded to the stage max) — static slice. Else:
        gather-select from the dense [U] row (identity when dense)."""
        if keeprows:
            return x[..., :Uc_of[cid]]
        if grid["dense"]:
            return x
        return jnp.take(x, keep_of[cid], axis=-1)

    def _g_dense(g0):
        """Re-expand a compacted aggregate cotangent to the dense [C*U]
        axis so the per-curve stage slices below stay index-arithmetic
        (dense-row fallback mode only). A static GATHER of [C*U]
        (unreferenced entries read an appended zero) — never an f64
        scatter."""
        if grid["dense"]:
            return g0
        pad = jnp.concatenate([g0, jnp.zeros(1, g0.dtype)])
        return pad[jnp.asarray(grid["inv"])]

    def _stage_g(g0, st, si):
        """The aggregate cotangent laid out over one stage's row
        output [G, W]. keeprows: static slice-place each member's
        compact segment (pad columns carry zero — they multiply pad
        row outputs). Else: per-curve slices of the dense cotangent."""
        if not keeprows:
            return jnp.stack([g0[cid * U:(cid + 1) * U]
                              for cid in st.ids])
        W = int(bat0[st.key]["row_plan_keep"]["q"].shape[1])
        out = jnp.zeros((len(st.ids), W), g0.dtype)
        for mi, cid in enumerate(st.ids):
            seg = g0[int(offs[cid]):int(offs[cid]) + Uc_of[cid]]
            out = out.at[mi, :Uc_of[cid]].set(seg)
        return out

    def fwd_delta(qvec, P, agg, clamp_agg):
        B = P["bat"]
        ut = P["unique_times"]
        dt = qvec.dtype

        ds_of: List = [None] * C        # cid -> [P1] native dfs
        rows_of: List = [None] * C      # cid -> [U]
        dds_st: Dict[int, jnp.ndarray] = {}    # si -> [Qp, G, P1]
        drows_st: Dict[int, jnp.ndarray] = {}  # si -> [Dirs, G, U]
        carry: Dict[int, dict] = {}     # si -> term2 boundary arrays

        # ---- pass 1: OIS + inflation stages (primal + Qp-seed jvp) ---
        for si in ois_first:
            st = stages[si]
            b = B[st.key]
            q_local = qvec[b["qidx"]]                       # [G, Qp]
            G, Qp = q_local.shape

            def fwd(r, b=b, st=st, si=si):
                ds = (ois_native_ds(r, b) if st.kind == "ois"
                      else infl_native_ds(r, b))
                rows = stage_rows(ut, b["ts_static"], ds, its_of[si],
                                  _rp(b))
                return ds, rows

            (ds, rows), jvp = jax.linearize(fwd, q_local)
            seeds = jnp.broadcast_to(
                jnp.eye(Qp, dtype=dt)[:, None, :], (Qp, G, Qp))
            dds, drows = jax.vmap(jvp)(seeds)
            dds_st[si] = dds
            drows_st[si] = drows
            for mi, cid in enumerate(st.ids):
                ds_of[cid] = ds[mi]
                rows_of[cid] = rows[mi]

        # ---- pass 2: XCCY stages (composed parent directions) --------
        for si in xccy_last:
            st = stages[si]
            b = B[st.key]
            m = xmeta[si]
            spreads = qvec[b["qidx"]]                       # [G, S]
            G, S = spreads.shape
            D = m["D"]

            Ld = b["dom_ts"].shape[1]
            Lf = b["for_ts"].shape[1]

            def pad_to(v, L):
                return jnp.concatenate(
                    [v, jnp.ones(L - v.shape[0], v.dtype)])

            dom_ds = jnp.stack([pad_to(ds_of[st.dom_ids[mi]], Ld)
                                for mi in range(G)])
            for_ds = jnp.stack([pad_to(ds_of[st.for_ids[mi]], Lf)
                                for mi in range(G)])

            if m["parents"] is None:
                # recal=False: parent grids enter as VALUES only
                # (xccy_native_ds stop-gradients them), so basis spreads
                # are the only differentiation directions
                def fwd(sp, b=b, st=st, si=si, dom_ds=dom_ds,
                        for_ds=for_ds):
                    ds = xccy_native_ds(sp, dom_ds, for_ds, b, st)
                    rows = stage_rows(ut, b["ts_static"], ds, its_of[si],
                                  _rp(b))
                    return ds, rows

                (ds, rows), jvp = jax.linearize(fwd, spreads)
                seeds = jnp.broadcast_to(
                    jnp.eye(S, dtype=dt)[:, None, :], (S, G, S))
                _, drows = jax.vmap(jvp)(seeds)
                drows_st[si] = drows
                for mi, cid in enumerate(st.ids):
                    ds_of[cid] = ds[mi]
                    rows_of[cid] = rows[mi]
                carry[si] = dict(dom_ds=dom_ds, for_ds=for_ds)
                continue

            # --- legs sub-stage: the dom curve reaches the bootstrap
            # ONLY through the [G, S] calibration-leg PVs, so dom-quote
            # directions compose through this S-value bottleneck instead
            # of re-differentiating the whole stage per dom direction ---
            def legs_fn(dd, b=b, st=st):
                return xccy_legs_pv(dd, b, st)

            pv0, jvp_legs = jax.linearize(legs_fn, dom_ds)
            Qd = max(p["qd"].shape[0] for p in m["parents"])
            Qf = max(p["qf"].shape[0] for p in m["parents"])
            td_legs = jnp.zeros((Qd, G, Ld), dt)
            for mi in range(G):
                p = m["parents"][mi]
                Jd = dds_st[p["sd"]][:, p["md"], :]        # [Qd_m, P1d]
                td_legs = td_legs.at[
                    :p["qd"].shape[0], mi, :p["p1d"]].set(Jd)
            Jpv = jax.vmap(jvp_legs)(td_legs)              # [Qd, G, S]

            # --- boot sub-stage over (spreads, pv, foreign grids) ----
            def boot_fn(sp, pv, fd, b=b, st=st, si=si):
                ds = xccy_boot_ds(sp, pv, fd, b, st)
                rows = stage_rows(ut, b["ts_static"], ds, its_of[si],
                                  _rp(b))
                return ds, rows

            (ds, rows), jvp_boot = jax.linearize(boot_fn, spreads, pv0,
                                                 for_ds)

            # boot directions: basis units, pv units, composed foreign
            D2 = 2 * S + Qf
            eyeS = jnp.broadcast_to(
                jnp.eye(S, dtype=dt)[:, None, :], (S, G, S))
            tb2 = jnp.zeros((D2, G, S), dt).at[:S].set(eyeS)
            tp2 = jnp.zeros((D2, G, S), dt).at[S:2 * S].set(eyeS)
            tf2 = jnp.zeros((D2, G, Lf), dt)
            for mi in range(G):
                p = m["parents"][mi]
                Jf = dds_st[p["sf"]][:, p["mf"], :]        # [Qf_m, P1f]
                tf2 = tf2.at[2 * S:2 * S + p["qf"].shape[0], mi,
                             :p["p1f"]].set(Jf)

            _, drows2 = jax.vmap(jvp_boot)(tb2, tp2, tf2)  # [D2, G, U]

            # compose to quote-direction space, per-member layout
            # matching _segments: [basis | dom quotes | foreign quotes]
            mems = []
            for mi in range(G):
                p = m["parents"][mi]
                qd_m, qf_m = p["qd"].shape[0], p["qf"].shape[0]
                dom_block = jnp.einsum("ds,su->du", Jpv[:qd_m, mi],
                                       drows2[S:2 * S, mi])
                mems.append(jnp.concatenate([
                    drows2[:S, mi],
                    dom_block,
                    drows2[2 * S:2 * S + qf_m, mi],
                    jnp.zeros((D - S - qd_m - qf_m,
                               drows2.shape[-1]), dt)]))
            drows_st[si] = jnp.stack(mems, axis=1)         # [D, G, U]
            for mi, cid in enumerate(st.ids):
                ds_of[cid] = ds[mi]
                rows_of[cid] = rows[mi]
            carry[si] = dict(dom_ds=dom_ds, for_ds=for_ds, pv0=pv0,
                             Jpv=Jpv, td_legs=td_legs, tf2=tf2)

        # ---- aggregate gradient --------------------------------------
        dfs_flat = jnp.concatenate(
            [_crop(rows_of[c], c) for c in range(C)])
        g = jax.grad(
            lambda d: aggregate_total(d, agg, clamp_agg))(dfs_flat)

        # ---- J assembly (contiguous slice placement, no matmuls) -----
        blocks = []
        for cid in range(C):
            si, mi = pos_of[cid]
            d_c = _crop(drows_st[si][:, mi, :], cid)
            blocks.append(_place_rows(d_c, _segments(si, mi),
                                      d_c.shape[-1]))
        J = jnp.concatenate(blocks, axis=1)       # [N, n_grid]
        return {"dfs": dfs_flat, "g": g, "J": J, "delta": J @ g,
                "carry": carry}

    # trip signature groups (host): the quad form contracts at each
    # group's closed quote width instead of full N — the staged B
    # region's warm wall (see multibook._term1_trip_groups). Built only
    # when the caller supplies the HOST aggregate (static trip tables).
    t1_groups = (None if host_agg is None
                 else _term1_trip_groups(basket, host_agg))

    def term1(J, dfs_flat, agg, clamp_agg):
        if t1_groups:
            return _gamma_quad_form_grouped(J, dfs_flat, agg, clamp_agg,
                                            t1_groups)
        return _gamma_quad_form(J, dfs_flat, agg, clamp_agg)

    def term2_xccy(qvec, P, g, carry):
        """XCCY-stage hessian placements + the chain cotangents their
        parents owe: returns (H2_xccy [N, N], v_of {str(cid): [P1]}).
        Separable from term2_ois so the staged builder compiles the two
        halves as concurrent programs (the combined term2 is the
        largest region compile)."""
        B = P["bat"]
        ut = P["unique_times"]
        dt = qvec.dtype

        # ---- per-stage hessians, XCCY first (cotangents flow onto the
        # parent OIS natives) ------------------------------------------
        g0 = jax.lax.stop_gradient(g)
        if not keeprows:
            g0 = _g_dense(g0)
        H2 = jnp.zeros((N, N), dt)
        v_of: Dict[str, jnp.ndarray] = {}

        for si in xccy_last:
            st = stages[si]
            b = B[st.key]
            m = xmeta[si]
            xs = carry[si]
            G = len(st.ids)
            S = m["S"]
            g_stage = _stage_g(g0, st, si)              # [G, W]
            spreads = qvec[b["qidx"]]                       # [G, S]

            if m["parents"] is None:
                def s_plain(sp, b=b, st=st, si=si, g_stage=g_stage,
                            dom_ds=xs["dom_ds"], for_ds=xs["for_ds"]):
                    ds = xccy_native_ds(sp, dom_ds, for_ds, b, st)
                    rows = stage_rows(ut, b["ts_static"], ds, its_of[si],
                                  _rp(b))
                    return jnp.vdot(g_stage, rows)

                gfun = jax.grad(s_plain)
                _, jvp2 = jax.linearize(gfun, spreads)
                seeds = jnp.broadcast_to(
                    jnp.eye(S, dtype=dt)[:, None, :], (S, G, S))
                Hx = jax.vmap(jvp2)(seeds)                 # [S, G, S]
                for mi, cid in enumerate(st.ids):
                    H2 = _place_hess(H2, Hx[:, mi, :],
                                     _segments(si, mi))
                continue

            def legs_fn(dd, b=b, st=st):
                return xccy_legs_pv(dd, b, st)

            def boot_fn(sp, pv, fd, b=b, st=st, si=si):
                ds = xccy_boot_ds(sp, pv, fd, b, st)
                rows = stage_rows(ut, b["ts_static"], ds, its_of[si],
                                  _rp(b))
                return ds, rows

            sp0, pv0, fd0 = spreads, xs["pv0"], xs["for_ds"]
            Jpv, td_legs, tf2 = xs["Jpv"], xs["td_legs"], xs["tf2"]
            Qd, Qf = td_legs.shape[0], tf2.shape[0] - 2 * S

            def s_boot(sp, pv, fd, g_stage=g_stage, boot_fn=boot_fn):
                _, rows = boot_fn(sp, pv, fd)
                return jnp.vdot(g_stage, rows)

            # boot-stage hessian over (basis, pv, composed-foreign)
            # dirs. fd enters as a SECOND primal so the linearize
            # PRIMAL yields both gZ = [gb | gpv | composed-f] and the
            # native-foreign cotangent gf in one fwd+bwd trace — the
            # former separate jax.grad(s_boot, argnums=(0,1,2)) trace
            # duplicated the whole bootstrap graph purely to recover
            # gradients the linearize already computes (compile-size
            # control: compile time grows with traced op count).
            def s_hat(Z, fd, sp0=sp0, pv0=pv0, tf2=tf2, S=S):
                sp2 = sp0 + Z[:, :S]
                pv2 = pv0 + Z[:, S:2 * S]
                fd2 = fd + jnp.einsum("gd,dgl->gl", Z, tf2)
                return s_boot(sp2, pv2, fd2)

            D2 = 2 * S + Qf
            gfun = jax.grad(s_hat, argnums=(0, 1))
            (gZ0, gf), jvp2 = jax.linearize(
                gfun, jnp.zeros((G, D2), dt), fd0)
            gpv = gZ0[:, S:2 * S]
            seeds = jnp.broadcast_to(
                jnp.eye(D2, dtype=dt)[:, None, :], (D2, G, D2))
            zfd = jnp.zeros_like(fd0)
            Hx2 = jax.vmap(lambda s: jvp2(s, zfd)[0])(seeds)
            # [D2, G, D2]; the unused d(gf) output is DCE'd at lowering

            # legs-stage hessian over dom-quote dirs (legs only):
            # sum_s gpv_s d2 pv_s / dq_dom2. dom_ds enters as a second
            # primal so the primal gradient IS the legs vjp cotangent
            # gdd — again one trace instead of two.
            gpv0 = jax.lax.stop_gradient(gpv)

            def s_legs(Zd, dd, gpv0=gpv0, td_legs=td_legs,
                       legs_fn=legs_fn):
                dd2 = dd + jnp.einsum("gd,dgl->gl", Zd, td_legs)
                return jnp.vdot(gpv0, legs_fn(dd2))

            gfun_l = jax.grad(s_legs, argnums=(0, 1))
            (_, gdd), jvp2_l = jax.linearize(
                gfun_l, jnp.zeros((G, Qd), dt), xs["dom_ds"])
            seeds_l = jnp.broadcast_to(
                jnp.eye(Qd, dtype=dt)[:, None, :], (Qd, G, Qd))
            zdd = jnp.zeros_like(xs["dom_ds"])
            Hl = jax.vmap(lambda s: jvp2_l(s, zdd)[0])(seeds_l)
            # [Qd, G, Qd]

            # cotangents at the primal: gdd routes to the dom parent's
            # native grid, gf to the foreign parent directly.
            for mi in range(G):
                p = m["parents"][mi]
                for cid_par, cot, p1 in (
                        (st.dom_ids[mi], gdd, p["p1d"]),
                        (st.for_ids[mi], gf, p["p1f"])):
                    prev = v_of.get(str(cid_par))
                    add = cot[mi, :p1]
                    v_of[str(cid_par)] = (add if prev is None
                                          else prev + add)

            # transform boot hessian to quote space per member and place
            for mi, cid in enumerate(st.ids):
                p = m["parents"][mi]
                qd_m, qf_m = p["qd"].shape[0], p["qf"].shape[0]
                Hb = Hx2[:, mi, :]                         # [D2, D2]
                Jv = Jpv[:qd_m, mi]                        # [qd_m, S]
                bb = Hb[:S, :S]
                bp = Hb[:S, S:2 * S]
                bf = Hb[:S, 2 * S:2 * S + qf_m]
                pp = Hb[S:2 * S, S:2 * S]
                pf = Hb[S:2 * S, 2 * S:2 * S + qf_m]
                ff = Hb[2 * S:2 * S + qf_m, 2 * S:2 * S + qf_m]
                q_bd = bp @ Jv.T                           # [S, qd_m]
                q_dd = Jv @ pp @ Jv.T + Hl[:qd_m, mi, :qd_m]
                q_df = Jv @ pf                             # [qd_m, qf_m]
                Hq = jnp.concatenate([
                    jnp.concatenate([bb, q_bd, bf], axis=1),
                    jnp.concatenate([q_bd.T, q_dd, q_df], axis=1),
                    jnp.concatenate([bf.T, q_df.T, ff], axis=1)],
                    axis=0)
                # Hq is laid out exactly over this member's segment dirs
                # (group-pad duplicate dirs folded by _place_hess)
                H2 = _place_hess(H2, Hq, _segments(si, mi))

        return H2, v_of

    def term2_ois(qvec, P, g, v_of):
        """OIS/inflation-stage hessian placements with the XCCY chain
        cotangents (term2_xccy's v_of) folded into each stage scalar."""
        B = P["bat"]
        ut = P["unique_times"]
        dt = qvec.dtype
        g0 = jax.lax.stop_gradient(g)
        if not keeprows:
            g0 = _g_dense(g0)
        H2 = jnp.zeros((N, N), dt)

        for si in ois_first:
            st = stages[si]
            b = B[st.key]
            q_local = qvec[b["qidx"]]
            G, Qp = q_local.shape
            g_stage = _stage_g(g0, st, si)              # [G, W]
            P1 = b["ts_static"].shape[1]
            v_stage = jnp.stack([
                v_of.get(str(cid), jnp.zeros(P1, dt))
                for cid in st.ids])

            def fwd(r, b=b, st=st, si=si):
                ds = (ois_native_ds(r, b) if st.kind == "ois"
                      else infl_native_ds(r, b))
                rows = stage_rows(ut, b["ts_static"], ds, its_of[si],
                                  _rp(b))
                return ds, rows

            def psi(r, fwd=fwd, g_stage=g_stage, v_stage=v_stage):
                ds, rows = fwd(r)
                return jnp.vdot(g_stage, rows) + jnp.vdot(v_stage, ds)

            gfun = jax.grad(psi)
            _, jvp2 = jax.linearize(gfun, q_local)
            seeds = jnp.broadcast_to(
                jnp.eye(Qp, dtype=dt)[:, None, :], (Qp, G, Qp))
            Hs = jax.vmap(jvp2)(seeds)                     # [Qp, G, Qp]
            for mi, cid in enumerate(st.ids):
                H2 = _place_hess(H2, Hs[:, mi, :], _segments(si, mi))

        return H2

    def term2(qvec, P, g, carry):
        H2x, v_of = term2_xccy(qvec, P, g, carry)
        return H2x + term2_ois(qvec, P, g, v_of)

    return dict(fwd_delta=fwd_delta, term1=term1, term2=term2,
                term2_xccy=term2_xccy, term2_ois=term2_ois, meta=meta)


def make_structured_risk(basket, host_agg=None):
    """Build scenario_risk(qvec, P, agg, clamp_agg, want_gamma) from the
    basket's batched stage topology. Requires the basket to have been
    compiled with batch_curves=True (basket._stages present).

    This is the monolithic composition of make_structured_parts — one
    traceable function a caller jits whole (multibook.make_multibook_fn
    does, vmapped over scenarios). For independently-compiled region
    programs use the parts directly (multibook.make_staged_multibook_fn).
    """
    parts = make_structured_parts(basket, host_agg=host_agg)
    fwd_delta = parts["fwd_delta"]
    term1 = parts["term1"]
    term2 = parts["term2"]
    N = parts["meta"]["N"]

    def scenario_risk(qvec, P, agg, clamp_agg, want_gamma,
                      terms=("t1", "t2")):
        fw = fwd_delta(qvec, P, agg, clamp_agg)
        out = {"delta": fw["delta"], "dfs": fw["dfs"]}
        if not want_gamma:
            return out
        dt = qvec.dtype
        gamma = (term1(fw["J"], fw["dfs"], agg, clamp_agg)
                 if "t1" in terms else jnp.zeros((N, N), dt))
        if "t2" in terms:
            gamma = gamma + term2(qvec, P, fw["g"], fw["carry"])
        out["gamma"] = gamma
        return out

    return scenario_risk


def _so_tensor(f, x0, seeds):
    """Second-order directional-derivative tensor
    T[i, j, ...] = d^2 f/(d s_i)(d s_j) at x0, for member-parallel seed
    bases (outputs of different group members never mix, so one seed
    carries every member's direction at once)."""
    def one(s1):
        def inner(x):
            return jax.jvp(f, (x,), (s1,))[1]

        def two(s2):
            return jax.jvp(inner, (x0,), (s2,))[1]
        return jax.vmap(two)(seeds)
    return jax.vmap(one)(seeds)


def make_pertrade_curvehess(basket, restrict=None):
    """Build contract(qvec, P, G) -> [B, N, N] computing
    sum_k G[b, k] * d2 dfs_flat_k / dq dq for every trade b.

    The contraction is LINEAR in G, so the per-stage second-order
    response tensors (second-order jvps over each stage's OWN direction
    basis — at most ~48 directions squared through a small stage graph)
    are computed once per call and contracted with each trade's DF-space
    gradient by dense matmuls. This replaces jacfwd(jacfwd(grids))'s
    [C*U, N, N] tensor, whose N^2 tangent directions through the whole
    curve graph are intractable at flagship scale (184^2 = 33856
    directions; the per-stage tensors need ~3.5k TOTAL, each through
    only its own stage). Chain-rule terms across stages (XCCY -> parent
    OIS) flow exactly as in scenario term2, with the per-trade cotangent
    carried through the legs/boot jacobians by matmuls.

    ``restrict`` (pertrade_blocks.py block mode): dict(cids=[...],
    width=k) names a PARENT-CLOSED set of curves. contract then takes G
    as [B, T*U] (only the touched curves' DF rows, in sorted-cid order)
    and returns [B, k, k] — the gamma restricted to the block of the
    touched curves' quote slots (exact, not an approximation: every
    trade whose DF support lies inside the touched rows has zero gamma
    outside the block, because quotes outside it cannot move touched
    curves — the set is closed over XCCY parents). Stages with no
    touched member and no touched-stage parent are skipped entirely."""
    meta = _build_meta(basket)
    stages = meta["stages"]
    specs = meta["specs"]
    C, N, U = meta["C"], meta["N"], meta["U"]
    bat0 = meta["bat0"]
    pos_of = meta["pos_of"]
    its_of = meta["its_of"]
    xmeta = meta["xmeta"]
    _segments_global = meta["segments"]
    _place_hess = meta["place_hess"]
    ois_first = meta["ois_first"]
    xccy_last = meta["xccy_last"]

    if restrict is None:
        touched = set(range(C))
        width = N
        row_pos = {cid: cid for cid in range(C)}
        _segments = _segments_global
    else:
        touched = set(restrict["cids"])
        width = int(restrict["width"])
        cids_sorted = sorted(touched)
        row_pos = {cid: i for i, cid in enumerate(cids_sorted)}
        # global quote offset -> block quote offset
        offmap = {}
        blk_off = 0
        for cid in cids_sorted:
            offmap[specs[cid].offset] = blk_off
            blk_off += specs[cid].n_quotes
        assert blk_off == width

        def _segments(si, mi):
            return [(offmap[off], n, lo, nd)
                    for off, n, lo, nd in _segments_global(si, mi)]

        # stages needed: any touched member, or parent of a touched
        # XCCY member (closure guarantees those parents are touched too,
        # but their whole STAGE must run so stacked parent grids exist)
        needed = set()
        for si, st in enumerate(stages):
            if any(cid in touched for cid in st.ids):
                needed.add(si)
        for si in xccy_last:
            st = stages[si]
            # parents must run even for recal=False stages: the member
            # loop stacks every member's parent PRIMAL grids
            if si in needed:
                for mi in range(len(st.ids)):
                    needed.add(pos_of[st.dom_ids[mi]][0])
                    needed.add(pos_of[st.for_ids[mi]][0])
        ois_first = [si for si in ois_first if si in needed]
        xccy_last = [si for si in xccy_last if si in needed]

    def contract(qvec, P, G):
        B = P["bat"]
        ut = P["unique_times"]
        dt = qvec.dtype
        Bn = G.shape[0]
        if restrict is None and not meta["grid"]["dense"]:
            # G arrives on the COMPACTED grid axis (multibook's
            # selected-gamma kernel builds it from the compact cols);
            # re-expand by gather so the per-curve row slices below
            # stay index arithmetic. restrict mode is untouched: its G
            # is already dense over the touched curves' [T*U] rows.
            pad = jnp.concatenate([G, jnp.zeros((Bn, 1), G.dtype)],
                                  axis=1)
            G = pad[:, jnp.asarray(meta["grid"]["inv"])]
        out = jnp.zeros((Bn, width, width), dt)

        def g_rows(cid):
            """This trade-batch's DF-space gradient rows for curve cid,
            or None when the curve is outside the restricted row set."""
            if cid not in touched:
                return None
            r = row_pos[cid]
            return G[:, r * U:(r + 1) * U]

        ds_of: List = [None] * C
        dds_st: Dict[int, jnp.ndarray] = {}
        fwd_of: Dict[int, object] = {}
        so_st: Dict[int, tuple] = {}      # si -> (dsT, rowsT) tensors

        # second-order tensors are only needed where a placement will
        # read them: stages with a touched member, or stages receiving a
        # chain cotangent (parents of touched XCCY members)
        so_needed = set()
        for si in ois_first:
            if any(cid in touched for cid in stages[si].ids):
                so_needed.add(si)
        for si in xccy_last:
            st = stages[si]
            if xmeta[si]["parents"] is not None:
                for mi, cid in enumerate(st.ids):
                    if cid in touched:
                        so_needed.add(pos_of[st.dom_ids[mi]][0])
                        so_needed.add(pos_of[st.for_ids[mi]][0])

        # -------- OIS / inflation stages ------------------------------
        for si in ois_first:
            st = stages[si]
            b = B[st.key]
            q_local = qvec[b["qidx"]]
            Gm, Qp = q_local.shape

            def fwd(r, b=b, st=st, si=si):
                ds = (ois_native_ds(r, b) if st.kind == "ois"
                      else infl_native_ds(r, b))
                rows = stage_rows(ut, b["ts_static"], ds, its_of[si],
                                  b.get("row_plan"))
                return ds, rows

            fwd_of[si] = fwd
            (ds, rows), jvp = jax.linearize(fwd, q_local)
            seeds = jnp.broadcast_to(
                jnp.eye(Qp, dtype=dt)[:, None, :], (Qp, Gm, Qp))
            dds, _ = jax.vmap(jvp)(seeds)
            dds_st[si] = dds
            for mi, cid in enumerate(st.ids):
                ds_of[cid] = ds[mi]
            if si in so_needed:
                # [Qp, Qp, G, P1] and [Qp, Qp, G, U]
                so_st[si] = _so_tensor(fwd, q_local, seeds)

        # own-stage terms for OIS/inflation members
        for si in ois_first:
            if si not in so_st:
                continue
            st = stages[si]
            _, rowsT = so_st[si]
            for mi, cid in enumerate(st.ids):
                Gb = g_rows(cid)                            # [B, U]
                if Gb is None:
                    continue
                Hm = jnp.einsum("bu,iju->bij", Gb,
                                rowsT[:, :, mi, :])
                out = _place_hess(out, Hm, _segments(si, mi))

        # -------- XCCY stages -----------------------------------------
        vnat: Dict[int, jnp.ndarray] = {}   # parent cid -> [B, P1] cot
        for si in xccy_last:
            st = stages[si]
            b = B[st.key]
            m = xmeta[si]
            spreads = qvec[b["qidx"]]
            Gm, S = spreads.shape
            Ld = b["dom_ts"].shape[1]
            Lf = b["for_ts"].shape[1]

            def pad_to(v, L):
                return jnp.concatenate(
                    [v, jnp.ones(L - v.shape[0], v.dtype)])

            dom_ds = jnp.stack([pad_to(ds_of[st.dom_ids[mi]], Ld)
                                for mi in range(Gm)])
            for_ds = jnp.stack([pad_to(ds_of[st.for_ids[mi]], Lf)
                                for mi in range(Gm)])

            if m["parents"] is None:
                def fwd0(sp, b=b, st=st, si=si, dom_ds=dom_ds,
                         for_ds=for_ds):
                    ds = xccy_native_ds(sp, dom_ds, for_ds, b, st)
                    return stage_rows(ut, b["ts_static"], ds,
                                      its_of[si], b.get("row_plan"))

                seeds = jnp.broadcast_to(
                    jnp.eye(S, dtype=dt)[:, None, :], (S, Gm, S))
                rowsT = _so_tensor(fwd0, spreads, seeds)
                for mi, cid in enumerate(st.ids):
                    Gb = g_rows(cid)
                    if Gb is None:
                        continue
                    Hm = jnp.einsum("bu,iju->bij", Gb,
                                    rowsT[:, :, mi, :])
                    out = _place_hess(out, Hm, _segments(si, mi))
                continue

            # legs sub-stage
            def legs_fn(dd, b=b, st=st):
                return xccy_legs_pv(dd, b, st)

            pv0, jvp_legs = jax.linearize(legs_fn, dom_ds)
            Qd = max(p["qd"].shape[0] for p in m["parents"])
            Qf = max(p["qf"].shape[0] for p in m["parents"])
            td_legs = jnp.zeros((Qd, Gm, Ld), dt)
            for mi in range(Gm):
                p = m["parents"][mi]
                Jd = dds_st[p["sd"]][:, p["md"], :]
                td_legs = td_legs.at[
                    :p["qd"].shape[0], mi, :p["p1d"]].set(Jd)
            Jpv = jax.vmap(jvp_legs)(td_legs)              # [Qd, G, S]

            # dpv/d(dom native): S reverse passes, member-parallel
            _, legs_vjp = jax.vjp(legs_fn, dom_ds)
            eyeS_out = jnp.broadcast_to(
                jnp.eye(S, dtype=dt)[:, None, :], (S, Gm, S))
            Jlegs_nat = jax.vmap(lambda ct: legs_vjp(ct)[0])(
                eyeS_out)                                  # [S, G, Ld]

            # boot sub-stage rows over (basis, pv, composed-foreign)
            tf2 = jnp.zeros((2 * S + Qf, Gm, Lf), dt)
            for mi in range(Gm):
                p = m["parents"][mi]
                Jf = dds_st[p["sf"]][:, p["mf"], :]
                tf2 = tf2.at[2 * S:2 * S + p["qf"].shape[0], mi,
                             :p["p1f"]].set(Jf)
            D2 = 2 * S + Qf

            def boot_z(Z, b=b, st=st, si=si, spreads=spreads, pv0=pv0,
                       for_ds=for_ds, tf2=tf2, S=S):
                sp2 = spreads + Z[:, :S]
                pv2 = pv0 + Z[:, S:2 * S]
                fd2 = for_ds + jnp.einsum("gd,dgl->gl", Z, tf2)
                ds = xccy_boot_ds(sp2, pv2, fd2, b, st)
                return stage_rows(ut, b["ts_static"], ds, its_of[si],
                                  b.get("row_plan"))

            Z0 = jnp.zeros((Gm, D2), dt)
            rows0, jvp_boot = jax.linearize(boot_z, Z0)
            seedsD = jnp.broadcast_to(
                jnp.eye(D2, dtype=dt)[:, None, :], (D2, Gm, D2))
            drows2 = jax.vmap(jvp_boot)(seedsD)            # [D2, G, U]
            rowsTx = _so_tensor(boot_z, Z0, seedsD)  # [D2, D2, G, U]

            # d rows / d (foreign native): Lf forward dirs, boot only
            def boot_fd(fd, b=b, st=st, si=si, spreads=spreads,
                        pv0=pv0):
                ds = xccy_boot_ds(spreads, pv0, fd, b, st)
                return stage_rows(ut, b["ts_static"], ds, its_of[si],
                                  b.get("row_plan"))

            _, jvp_fd = jax.linearize(boot_fd, for_ds)
            eyeLf = jnp.broadcast_to(
                jnp.eye(Lf, dtype=dt)[:, None, :], (Lf, Gm, Lf))
            drows_fd = jax.vmap(jvp_fd)(eyeLf)             # [Lf, G, U]

            # legs second-order over composed dom-quote dirs
            def legs_z(Zd, td_legs=td_legs, dom_ds=dom_ds,
                       legs_fn=legs_fn):
                return legs_fn(
                    dom_ds + jnp.einsum("gd,dgl->gl", Zd, td_legs))

            seedsQd = jnp.broadcast_to(
                jnp.eye(Qd, dtype=dt)[:, None, :], (Qd, Gm, Qd))
            legsT = _so_tensor(legs_z, jnp.zeros((Gm, Qd), dt),
                               seedsQd)                # [Qd, Qd, G, S]

            for mi, cid in enumerate(st.ids):
                p = m["parents"][mi]
                qd_m, qf_m = p["qd"].shape[0], p["qf"].shape[0]
                Gb = g_rows(cid)                            # [B, U]
                if Gb is None:
                    continue
                # per-trade cotangents through the bottlenecks
                w_pv = jnp.einsum("bu,su->bs", Gb,
                                  drows2[S:2 * S, mi])      # [B, S]
                v_dom = jnp.einsum("bs,sl->bl", w_pv,
                                   Jlegs_nat[:, mi, :])     # [B, Ld]
                v_for = jnp.einsum("bu,lu->bl", Gb,
                                   drows_fd[:, mi, :])      # [B, Lf]
                dcid, fcid = st.dom_ids[mi], st.for_ids[mi]
                for cid_par, vb, p1 in ((dcid, v_dom, p["p1d"]),
                                        (fcid, v_for, p["p1f"])):
                    prev = vnat.get(cid_par)
                    add = vb[:, :p1]
                    vnat[cid_par] = add if prev is None else prev + add

                # boot-stage hessian contracted with this trade
                Hb = jnp.einsum("bu,iju->bij", Gb,
                                rowsTx[:, :, mi, :])     # [B, D2, D2]
                Jv = Jpv[:qd_m, mi]                      # [qd_m, S]
                bb = Hb[:, :S, :S]
                bp = Hb[:, :S, S:2 * S]
                bf = Hb[:, :S, 2 * S:2 * S + qf_m]
                pp = Hb[:, S:2 * S, S:2 * S]
                pf = Hb[:, S:2 * S, 2 * S:2 * S + qf_m]
                ff = Hb[:, 2 * S:2 * S + qf_m, 2 * S:2 * S + qf_m]
                q_bd = jnp.einsum("bsp,dp->bsd", bp, Jv)
                q_dd = jnp.einsum("dp,bpq,eq->bde", Jv, pp, Jv) \
                    + jnp.einsum("bs,ijs->bij", w_pv,
                                 legsT[:qd_m, :qd_m, mi, :])
                q_df = jnp.einsum("dp,bpf->bdf", Jv, pf)
                Hq = jnp.concatenate([
                    jnp.concatenate([bb, q_bd, bf], axis=2),
                    jnp.concatenate([jnp.swapaxes(q_bd, 1, 2), q_dd,
                                     q_df], axis=2),
                    jnp.concatenate([jnp.swapaxes(bf, 1, 2),
                                     jnp.swapaxes(q_df, 1, 2), ff],
                                    axis=2)], axis=1)
                out = _place_hess(out, Hq, _segments(si, mi))

        # -------- parent-chain second-order terms ---------------------
        for si in ois_first:
            if si not in so_st:
                continue
            st = stages[si]
            dsT, _ = so_st[si]
            for mi, cid in enumerate(st.ids):
                vb = vnat.get(cid)
                if vb is None:
                    continue
                Hm = jnp.einsum("bl,ijl->bij", vb,
                                dsT[:, :, mi, :])
                out = _place_hess(out, Hm, _segments(si, mi))
        return out

    return contract
