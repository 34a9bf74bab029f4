"""Differentiable OIS curve bootstrap — static point plan + lax.scan solve.

The reference bootstraps recursively in Python with a rounded-key pv01 memo
(/root/reference/cavour/trades/rates/ois_curve.py:156-212) and re-derives a
lax.scan twin inside the engine (engine.py:2246-2360). Here there is ONE
canonical formulation, split into a host-side plan and a device solve:

 - *plan* (trade-compile time, Python): expand every coupon of every
   calibration swap into a sorted point list with prev-point dependency
   links, deduplicated by the reference's 2-decimal rounded-key memo
   semantics. Pure static integer/float arrays.
 - *solve* (device, differentiable): the par recurrence
   df_i = (1 - r_i * pv01_prev) / (1 + r_i * acc_i),
   pv01_i = pv01_prev + acc_i * df_i, which is the LINEAR recurrence
   pv01_i = (pv01_prev + acc_i) / (1 + r_i * acc_i). It is solved by a
   wavefront fixed-point iteration over the whole point vector: K = max
   dependency depth iterations of [P]-shaped gather + fused elementwise
   ops. This keeps the carry math off rank-0 shapes (docs/f64_notes.md
   rule 3), and the wavefront does K < P fully vectorized passes instead
   of P sequential scalar steps. Sub-pillar
   points take their rate from log-linear interpolation of the pillar
   rates (ois_curve.py:168-179) so intermediate curve smoothness matches
   the reference's curve-build path. Pillar par conditions hold exactly
   regardless, so every input swap reprices to 1e-10 by construction.

Fixes folded in (SURVEY §7 "deliberate non-goals"): no duplicate bogus
points on the dense grid (the engine twin kept first-coupon duplicates with
wrong DFs, engine.py:2334-2353), and a missing-first-coupon key bootstraps
from pv01=0 instead of the reference's IndexError
(tests/test_par_swap_repricing.py:17-19).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class OISBootstrapPlan:
    """Static topology of an OIS bootstrap (a pytree of arrays).

    The plan is a registered pytree so it can be passed as a jit ARGUMENT:
    every jitted pricing function takes the plan as an argument and never
    closes over it (docs/f64_notes.md rule 6).

    point_times: [P] exact time of each bootstrap point (sorted ascending)
    accs:        [P] accrual fraction of the period ending at the point
    prev_idx:    [P] index of the previous coupon's point (-1 → pv01 = 0)
    pillar_idx:  [P] index into the pillar rate vector when the point is a
                 pillar maturity, else -1 (rate comes from log-linear
                 interpolation of pillar rates at point_times)
    swap_times:  [S] pillar maturities (interpolation x-grid)
    pillar_point:[S] index of each pillar's point in the point arrays
    """
    point_times: np.ndarray
    accs: np.ndarray
    prev_idx: np.ndarray
    pillar_idx: np.ndarray
    swap_times: np.ndarray
    pillar_point: np.ndarray
    # [P, P] 0/1 one-hot of prev_idx (row i hot at prev(i)): the pv01
    # system's transpose runs as a dense matvec against this instead of a
    # scatter-add (chosen where f64 scatters were slow; not yet measured
    # against a scatter on the GPU). P <= ~100, so the matrix is a few
    # tens of KB.
    prev_onehot: np.ndarray = None
    depth: int = dataclasses.field(
        default=0, metadata=dict(static=True))  # max dependency-chain length
    loglinear_rates: bool = dataclasses.field(
        default=True, metadata=dict(static=True))  # rate interp space
    # [P, Kc] child table (points whose prev is this point) + 0/1 mask:
    # makes the pv01 system's TRANSPOSE a gather too, so the K-sweep
    # solver touches no [P, P] matrix at all (see the solver note in
    # bootstrap_ois).
    child_idx: np.ndarray = None
    child_mask: np.ndarray = None
    # Static sub-pillar rate-interpolation weights (point_times x
    # swap_times are both static, so searchsorted + jnp.interp's guards
    # need not live in the traced graph — they multiply through every AD
    # level of every stage trace, and compile seconds track traced op
    # count). Same (i0, i1, c) serves the log
    # and linear spaces: the weights depend only on the time grids.
    rate_i0: np.ndarray = None       # [P] int32
    rate_i1: np.ndarray = None       # [P] int32
    rate_c: np.ndarray = None        # [P] f64 fractional weight


def prepare_ois_plan(swap_times: Sequence[float],
                     year_fracs: Sequence[Sequence[float]],
                     loglinear_rates: bool = True) -> OISBootstrapPlan:
    """Expand calibration swaps into the static bootstrap point plan.

    Runs once per curve topology in Python; everything downstream is jitted.
    Reproduces the reference's rounded-2dp memo: a sub-pillar coupon point is
    created only when no point with the same rounded cumulative-time key
    exists yet; pillar points always exist and take ownership of their key.
    """
    points: List[dict] = []
    by_key = {}          # rounded key -> point index
    ROUND = 2

    def key_of(t: float) -> float:
        return round(t, ROUND)

    for i, fracs in enumerate(year_fracs):
        cum = 0.0
        prev_point = -1  # pv01 = 0 base
        for j, frac in enumerate(fracs):
            cum += float(frac)
            k = key_of(cum)
            is_final = (j == len(fracs) - 1)
            if is_final:
                # Pillar point: exact time is the swap's quoted maturity
                # time (last coupon date), not the year-frac cumsum
                # (ois_curve.py:141-148).
                t_point = float(swap_times[i])
                points.append(dict(t=t_point, acc=float(frac),
                                   prev=prev_point, pillar=i))
                by_key[k] = len(points) - 1
                prev_point = len(points) - 1
            else:
                if k in by_key:
                    prev_point = by_key[k]
                else:
                    points.append(dict(t=cum, acc=float(frac),
                                       prev=prev_point, pillar=-1))
                    by_key[k] = len(points) - 1
                    prev_point = len(points) - 1

    # Sort by time, remapping dependency links.
    order = sorted(range(len(points)), key=lambda idx: points[idx]["t"])
    remap = {old: new for new, old in enumerate(order)}
    sorted_points = [points[old] for old in order]

    point_times = np.array([p["t"] for p in sorted_points])
    accs = np.array([p["acc"] for p in sorted_points])
    prev_idx = np.array([remap[p["prev"]] if p["prev"] >= 0 else -1
                         for p in sorted_points], dtype=np.int32)
    pillar_idx = np.array([p["pillar"] for p in sorted_points],
                          dtype=np.int32)
    pillar_point = np.full(len(swap_times), -1, dtype=np.int32)
    for idx, p in enumerate(sorted_points):
        if p["pillar"] >= 0:
            pillar_point[p["pillar"]] = idx

    # Dependencies must point strictly backward (DAG, no cycles).
    assert np.all(prev_idx < np.arange(len(sorted_points))), \
        "bootstrap dependency cycle — check calibration swap ordering"

    # Max chain depth: number of wavefront iterations needed to settle.
    depths = np.zeros(len(sorted_points), dtype=np.int64)
    for idx in range(len(sorted_points)):
        p = prev_idx[idx]
        depths[idx] = 1 if p < 0 else depths[p] + 1
    depth = int(depths.max()) if len(sorted_points) else 0

    P = len(sorted_points)
    prev_onehot = np.zeros((P, P))
    rows = np.nonzero(prev_idx >= 0)[0]
    prev_onehot[rows, prev_idx[rows]] = 1.0

    children: List[List[int]] = [[] for _ in range(P)]
    for i in rows:
        children[prev_idx[i]].append(int(i))
    kc = max((len(c) for c in children), default=1) or 1
    child_idx = np.zeros((P, kc), dtype=np.int64)
    child_mask = np.zeros((P, kc))
    for j, c in enumerate(children):
        for k, i in enumerate(c):
            child_idx[j, k] = i
            child_mask[j, k] = 1.0

    sw = np.asarray(swap_times, dtype=float)
    ri = np.clip(np.searchsorted(sw, point_times, side="right"), 1,
                 max(sw.shape[0] - 1, 1))
    ri0 = (ri - 1).astype(np.int64)
    ri1 = ri.astype(np.int64)
    dx = sw[ri1] - sw[ri0]
    dx0 = np.abs(dx) <= np.spacing(np.finfo(np.float64).eps)
    rc = np.where(dx0, 0.0,
                  (point_times - sw[ri0]) / np.where(dx0, 1.0, dx))
    lo = point_times < sw[0]
    hi = point_times > sw[-1]
    ri0[lo] = 0
    ri1[lo] = 0
    ri0[hi] = sw.shape[0] - 1
    ri1[hi] = sw.shape[0] - 1
    rc[lo | hi] = 0.0

    return OISBootstrapPlan(point_times=point_times, accs=accs,
                            prev_idx=prev_idx, pillar_idx=pillar_idx,
                            swap_times=sw,
                            pillar_point=pillar_point,
                            prev_onehot=prev_onehot, depth=depth,
                            loglinear_rates=loglinear_rates,
                            child_idx=child_idx, child_mask=child_mask,
                            rate_i0=ri0.astype(np.int32),
                            rate_i1=ri1.astype(np.int32), rate_c=rc)


def bootstrap_ois(rates, plan: OISBootstrapPlan):
    """Solve the bootstrap: pillar rates -> (times, dfs) dense grid.

    Differentiable w.r.t. ``rates``. Returns times/dfs WITH the t=0 node
    (df=1) prepended.

    Wavefront solve of the linear pv01 recurrence
        pv01_i = (pv01_prev(i) + acc_i) / (1 + r_i * acc_i):
    iterate the whole-vector update K times (K = plan.depth); after k
    iterations every chain of depth <= k has settled, so K iterations give
    the exact fixed point. Every op is [P]-shaped, never a rank-0 scan
    carry (docs/f64_notes.md rule 3).
    """
    rates = jnp.asarray(rates)
    times = jnp.asarray(plan.point_times)
    accs = jnp.asarray(plan.accs)
    prev_idx = jnp.asarray(plan.prev_idx)
    pillar_idx = jnp.asarray(plan.pillar_idx)
    swap_times = jnp.asarray(plan.swap_times)

    # Sub-pillar rates: log-linear in the pillar rates
    # (ois_curve.py:168-173). Falls back to linear space when the curve was
    # built from non-positive quotes (negative-rate markets) — log of a
    # negative rate NaNs the whole bootstrap, a latent bug in the
    # reference. The build-time flag alone is NOT enough: scenario
    # engines shock the quote vector inside the jitted graph, so a
    # low-rate curve (e.g. JPY short end at ~30bp) can cross zero at
    # runtime. Guard in-graph: clamp the log argument (the clamped
    # branch's gradient is exactly zero, so no NaN leaks through AD)
    # and select linear-space interpolation whenever any pillar rate is
    # non-positive.
    has_static = plan.rate_i0 is not None
    if has_static:
        # static-weight interpolation (see the plan-field comment): the
        # same IEEE-f64 c as jnp.interp computes, combined with the
        # same fp[i0] + c*df expression — only 2 gathers + 3 elementwise ops in
        # the traced graph instead of searchsorted + interp guards.
        ri0 = jnp.asarray(plan.rate_i0)
        ri1 = jnp.asarray(plan.rate_i1)
        rc = jnp.asarray(plan.rate_c)

        def interp_static(y):
            y0 = y[ri0]
            return y0 + rc * (y[ri1] - y0)
    if plan.loglinear_rates:
        # clamp floor must keep 1/safe**2 finite: second-order AD of
        # log(max(r, c)) materializes -1/safe^2 as a linearization
        # constant, and c=1e-300 overflowed it to -Inf whose product
        # with the max's zero tangent is NaN (the 368-entry gamma NaN
        # on the flagship book: one scenario pushed a JPY pillar
        # through zero). 1e-8 (0.0001 bp) keeps every AD order finite
        # and only bites where log-linear rate interpolation is
        # numerically meaningless anyway.
        safe = jnp.maximum(rates, 1e-8)
        if has_static:
            log_interp = jnp.exp(interp_static(jnp.log(safe)))
            lin_interp = interp_static(rates)
        else:
            log_interp = jnp.exp(jnp.interp(times, swap_times,
                                            jnp.log(safe)))
            lin_interp = jnp.interp(times, swap_times, rates)
        interp_rates = jnp.where(jnp.all(rates > 0.0), log_interp,
                                 lin_interp)
    else:
        interp_rates = (interp_static(rates) if has_static
                        else jnp.interp(times, swap_times, rates))
    point_rates = jnp.where(pillar_idx >= 0, rates[pillar_idx.clip(0)],
                            interp_rates)

    denom = 1.0 + point_rates * accs            # [P], exact
    has_prev = prev_idx >= 0
    gather_idx = prev_idx.clip(0)
    depth = max(plan.depth, 1)

    # pv01 solves the LINEAR triangular system (I - A) pv01 = b with
    #     A x = gather(x)/denom,  b = accs/denom,
    # exact after K = depth whole-vector sweeps (triangular: chains are
    # strictly backward). Differentiation goes through
    # lax.custom_linear_solve — the IFT adjoint done right for EVERY
    # order: each jvp/vjp level is ONE extra K-sweep scan solve (forward
    # or transposed), so jacfwd∘jacrev gamma towers stay O(depth) in both
    # runtime AND program size. (The previous custom_root formulation
    # needed an UNROLLED depth-step tangent solve for transposability —
    # under a 168-quote jacfwd∘jacrev across 10 curves that unrolling
    # exploded XLA compile time past 30 minutes.)
    def A(x):
        return jnp.where(has_prev, x[gather_idx], 0.0) / denom

    child_idx = jnp.asarray(plan.child_idx)
    child_mask = jnp.asarray(plan.child_mask)

    def A_t(y):
        # transpose of A via the static child table: position j collects
        # (y/denom) over the points whose prev is j — gathers, never a
        # scatter-add or a [P, P] matvec.
        yd = y / denom
        return jnp.sum(child_mask * yd[child_idx], axis=-1)

    b = accs / denom

    def matvec(x):
        return x - A(x)

    # Solve (I - A) x = b by K HORNER SWEEPS of the Neumann series
    # (x <- b + A x; exact after K = depth sweeps since A is nilpotent —
    # chains point strictly backward). Both A and A' are pure gathers.
    #
    # Why sweeps and not the earlier Neumann DOUBLING (x <- x + Mx,
    # M <- M@M): doubling's log2(depth) [P, P] matrix squarings are
    # O(P^3) flops PER SCENARIO and per solve instance. Under the
    # scenario-BATCHED risk pass (the production shape: the whole solve
    # graph is vmapped over ~100 scenarios) that is ~4 Gflop of
    # emulated-f64 matmuls per stage, while the sweeps are depth
    # sequential [batch, P]-shaped gather+divide steps whose per-step
    # dispatch amortizes across the batch — measured 52 ms -> (this
    # change) for the batched stage primal. Doubling only wins for
    # latency-bound SINGLE-scenario solves, which are not the hot path.
    K = max(depth, 1)

    def solve(_, b_):
        def step(x, _):
            return b_ + A(x), None
        x, __ = lax.scan(step, b_, None, length=K)
        return x

    def transpose_solve(_, y):
        def step(x, _):
            return y + A_t(x), None
        x, __ = lax.scan(step, y, None, length=K)
        return x

    pv01 = lax.custom_linear_solve(matvec, b, solve,
                                   transpose_solve=transpose_solve)

    prev_pv01 = jnp.where(has_prev, pv01[gather_idx], 0.0)
    dfs = (1.0 - point_rates * prev_pv01) / denom

    all_times = jnp.concatenate([jnp.zeros(1, times.dtype), times])
    all_dfs = jnp.concatenate([jnp.ones(1, dfs.dtype), dfs])
    return all_times, all_dfs


def bootstrap_pillar_dfs(rates, plan: OISBootstrapPlan):
    """Pillar-maturity DFs only (used for repricing gates)."""
    _, dfs = bootstrap_ois(rates, plan)
    return dfs[jnp.asarray(plan.pillar_point) + 1]  # +1 for the t=0 node
