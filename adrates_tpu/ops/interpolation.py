"""Curve interpolation kernels — pure JAX, differentiable, jittable.

All 8 interpolation schemes of the reference AD stack
(/root/reference/cavour/market/curves/interpolator_ad.py):

 - FLAT_FWD_RATES      linear in rt = -log(DF)          (piecewise-flat fwd)
 - LINEAR_ZERO_RATES   linear in r = -log(DF)/t
 - LINEAR_FWD_RATES    linear in DF itself
 - PCHIP_LOG_DISCOUNT  monotone Hermite on log(DF)
 - PCHIP_ZERO_RATES    monotone Hermite on zero rates
 - NATCUBIC_LOG_DISCOUNT / NATCUBIC_ZERO_RATES  natural cubic spline
 - FINCUBIC_ZERO_RATES clamped spline (S''(t0)=0, S'(tN)=0)

Design differences from the reference (upgrades, not ports):
 - PCHIP slopes are computed with vectorized masks instead of a fori_loop
   (interpolator_ad.py:24-52) — one fused elementwise pass, AD-safe 0/0
   guards.
 - Cubic-spline coefficients are solved *in JAX* (tridiagonal system via
   jnp.linalg.solve) instead of calling scipy (interpolator_ad.py:183),
   making splines differentiable end-to-end w.r.t. curve DFs.
 - Everything is a function of arrays; no stateful fit object on the hot
   path. Scheme dispatch is static so each variant jits to a single XLA
   computation.

The exact-knot guard of the reference (interpolator_ad.py:214-243) is
preserved: at grid points the stored DF is returned through lax.select so
gradients at knots don't become NaN (critical for 1e-10 par refits).

Why there is NO hand-written Pallas interpolation kernel (round-1 shipped
an f32 FLAT_FWD one; removed in round 2): the book-scale design interns
every cashflow time into one shared unique-time grid per curve
(parallel/multibook.py), so the hot sweeps GATHER precomputed DFs instead
of interpolating per cashflow. What interpolation remains on the hot path
is S x C x U queries per scenario sweep (~1e6 for the flagship config) —
about 0.1% of the sweep's work, fully fused by XLA into the surrounding
graph. A Mosaic kernel there would optimize a non-bottleneck while
adding an f32-only side path to a package whose calibration contract is
1e-10 in f64. If a future workload needs dense per-cashflow
interpolation at >1e8 queries, resurrect the kernel from git history
(ops/pallas_interp.py, commit f0a32cb).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..utils.error import LibError
from ..utils.global_types import InterpTypes
from ..utils.global_vars import gSmall

_SIMPLE_SCHEMES = (InterpTypes.FLAT_FWD_RATES, InterpTypes.LINEAR_ZERO_RATES,
                   InterpTypes.LINEAR_FWD_RATES)
_PCHIP_SCHEMES = (InterpTypes.PCHIP_LOG_DISCOUNT, InterpTypes.PCHIP_ZERO_RATES)
_CUBIC_SCHEMES = (InterpTypes.FINCUBIC_ZERO_RATES,
                  InterpTypes.NATCUBIC_ZERO_RATES,
                  InterpTypes.NATCUBIC_LOG_DISCOUNT)


class InterpAux(NamedTuple):
    """Precomputed per-curve interpolation state (a pytree).

    For PCHIP schemes: y = transformed knot values, d = Hermite slopes.
    For cubic schemes: y = transformed knot values, d unused, c = (4, N-1)
    polynomial coefficients (highest order first, scipy layout).
    For simple schemes both are empty.
    """
    y: Optional[jnp.ndarray] = None
    d: Optional[jnp.ndarray] = None
    c: Optional[jnp.ndarray] = None


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


def _zero_rates(times, dfs):
    """Continuously-compounded zero rates with the t=0 node patched to its
    neighbour (parity: interpolator_ad.py:167-170)."""
    zero = -jnp.log(dfs) / (times + gSmall)
    zero = zero.at[0].set(jnp.where(times[0] == 0, zero[1], zero[0]))
    return zero


# ---------------------------------------------------------------------------
# PCHIP
# ---------------------------------------------------------------------------


def pchip_slopes(x, y):
    """Shape-preserving Hermite slopes (weighted-harmonic-mean PCHIP).

    Matches the reference recurrence (interpolator_ad.py:24-52): endpoint
    slopes are the one-sided secants; interior slopes are the weighted
    harmonic mean of adjacent secants, zero where the secants change sign.
    Fully vectorized and AD-safe (guarded divisions).
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    h = x[1:] - x[:-1]                      # [n-1]
    m = (y[1:] - y[:-1]) / h                # [n-1] secants

    m0 = m[:-1]                             # secant left of interior node
    m1 = m[1:]                              # secant right of interior node
    h0 = h[:-1]
    h1 = h[1:]
    cond = (m0 * m1) > 0
    w1 = 2.0 * h1 + h0
    w2 = h1 + 2.0 * h0
    safe_m0 = jnp.where(cond, m0, 1.0)
    safe_m1 = jnp.where(cond, m1, 1.0)
    interior = jnp.where(cond, (w1 + w2) / (w1 / safe_m0 + w2 / safe_m1),
                         0.0)
    return jnp.concatenate([m[:1], interior, m[-1:]])


def hermite_eval(t, x, y, d):
    """Evaluate the cubic Hermite interpolant at (vector) t."""
    t = jnp.asarray(t)
    idx = jnp.clip(jnp.searchsorted(x, t) - 1, 0, x.size - 2)
    x0 = x[idx]
    x1 = x[idx + 1]
    y0 = y[idx]
    y1 = y[idx + 1]
    d0 = d[idx]
    d1 = d[idx + 1]
    h = x1 - x0
    s = (t - x0) / h
    s2 = s * s
    s3 = s2 * s
    h00 = 2.0 * s3 - 3.0 * s2 + 1.0
    h10 = s3 - 2.0 * s2 + s
    h01 = -2.0 * s3 + 3.0 * s2
    h11 = s3 - s2
    return h00 * y0 + h10 * h * d0 + h01 * y1 + h11 * h * d1


# ---------------------------------------------------------------------------
# Cubic splines (JAX-native fit — differentiable, unlike the scipy fit the
# reference uses)
# ---------------------------------------------------------------------------


def cubic_spline_coeffs(x, y, natural_left: bool = True,
                        clamped_right: bool = False):
    """Cubic-spline polynomial coefficients, scipy CubicSpline layout.

    Solves the slope (first-derivative) tridiagonal system with the Thomas
    algorithm (lax.scan) — differentiable, O(N), and free of LU solves
    (docs/f64_notes.md rule 4). Boundary conditions:
      natural_left:  S''(x0) = 0, else nothing special at the left
      clamped_right: S'(xN) = 0, else natural right (S''(xN) = 0)

    Returns c with shape (4, N-1): S(t) = c0 u^3 + c1 u^2 + c2 u + c3 on
    [x_i, x_{i+1}], u = t - x_i.
    """
    from ..utils.math import solve_tridiagonal

    x = jnp.asarray(x)
    y = jnp.asarray(y)
    n = x.shape[0]
    h = x[1:] - x[:-1]                      # [n-1]
    m = (y[1:] - y[:-1]) / h                # [n-1]

    # Tridiagonal system for the knot slopes s (size n):
    # interior rows enforce C2 continuity, boundary rows encode the BCs.
    inv_h = 1.0 / h
    lower = jnp.concatenate([jnp.zeros(1, x.dtype), inv_h[:-1],
                             jnp.ones(1, x.dtype)])
    diag = jnp.concatenate([2.0 * jnp.ones(1, x.dtype),
                            2.0 * (inv_h[:-1] + inv_h[1:]),
                            2.0 * jnp.ones(1, x.dtype)])
    upper = jnp.concatenate([jnp.ones(1, x.dtype), inv_h[1:],
                             jnp.zeros(1, x.dtype)])
    rhs = jnp.concatenate([3.0 * m[:1],
                           3.0 * (m[:-1] * inv_h[:-1] + m[1:] * inv_h[1:]),
                           3.0 * m[-1:]])
    if clamped_right:
        lower = lower.at[n - 1].set(0.0)
        diag = diag.at[n - 1].set(1.0)
        rhs = rhs.at[n - 1].set(0.0)

    s = solve_tridiagonal(lower, diag, upper, rhs)

    s0 = s[:-1]
    s1 = s[1:]
    c3 = y[:-1]
    c2 = s0
    c1 = (3.0 * m - 2.0 * s0 - s1) / h
    c0 = (s0 + s1 - 2.0 * m) / (h * h)
    return jnp.stack([c0, c1, c2, c3])


def cubic_eval(t, x, c):
    """Evaluate a piecewise cubic with coefficients (4, N-1) at vector t."""
    t = jnp.asarray(t)
    idx = jnp.clip(jnp.searchsorted(x, t) - 1, 0, x.size - 2)
    u = t - x[idx]
    return ((c[0, idx] * u + c[1, idx]) * u + c[2, idx]) * u + c[3, idx]


# ---------------------------------------------------------------------------
# Simple schemes with the exact-knot AD guard
# ---------------------------------------------------------------------------


def simple_df(t, times, dfs, interp_type: InterpTypes):
    """DF(t) for the three simple schemes, vectorized over t.

    Parity with the reference's jitted kernel (interpolator_ad.py:186-249):
    the evaluation point is nudged by +1e-12, endpoints clamp (constant
    extrapolation in transform space via jnp.interp), and exact grid points
    return the stored DF through lax.select so knot gradients stay finite.
    """
    t = jnp.asarray(t)
    x = jnp.asarray(times)
    d = jnp.asarray(dfs)
    scalar = (t.ndim == 0)
    tt = jnp.atleast_1d(t)
    padded = tt.shape[0] == 1
    if padded:
        tt = jnp.concatenate([tt, tt])  # no 1-element fused chains (rule 2)

    # interpolated value away from knots
    eps = 1e-12
    tt_adj = tt + eps
    if interp_type == InterpTypes.LINEAR_ZERO_RATES:
        r = -jnp.log(d) / jnp.maximum(x, 1e-15)
        # t=0 node (df=1) carries no rate information: patch its zero to
        # the first pillar's so sub-first-pillar queries extrapolate flat
        # instead of sloping toward r=0 (parity: the reference AD stack's
        # patch, interpolator_ad.py:167-170, and _zero_rates above).
        r = r.at[0].set(jnp.where(x[0] == 0.0, r[1], r[0]))
        interp_val = jnp.exp(-jnp.interp(tt_adj, x, r) * tt)
    elif interp_type == InterpTypes.FLAT_FWD_RATES:
        rt = -jnp.log(d)
        interp_val = jnp.exp(-jnp.interp(tt_adj, x, rt))
    elif interp_type == InterpTypes.LINEAR_FWD_RATES:
        interp_val = jnp.interp(tt_adj, x, d)
    else:
        raise LibError("Invalid interpolation scheme.")

    # exact-knot guard
    dist = jnp.abs(tt[:, None] - x[None, :])          # [T, N]
    grid_idx = jnp.argmin(dist, axis=1)
    at_grid = jnp.min(dist, axis=1) < 1e-10
    out = lax.select(at_grid, d[grid_idx], interp_val)
    if padded:
        out = out[:1]
    return out[0] if scalar else out


# ---------------------------------------------------------------------------
# Static interpolation plans (compile-size control, round 5)
# ---------------------------------------------------------------------------
# Everywhere the batched curve stages interpolate, BOTH the query times
# and the grid times are static (cashflow schedules and bootstrap node
# times are fixed at trade-compile time; only the DFs are traced). The
# dynamic simple_df path still pays searchsorted + the [T, N] exact-knot
# distance matrix + jnp.interp's guards IN THE GRAPH — ~45 StableHLO ops
# per call site, multiplied by every AD level of every stage trace, and
# compile time grows with traced op count. A static plan precomputes (i0, i1, c,
# knot guard) in numpy once and leaves only gathers + 4 arithmetic ops
# traced. Bitwise-identical to simple_df: c is the same IEEE-f64
# delta/dx jnp.interp computes, combined with the same fp[i0] + c*df
# expression, and the clamp/knot decisions are static rewrites of the
# same branches.


def simple_interp_plan(q, x, interp_type: InterpTypes) -> dict:
    """Precompute the static gather/weight plan replicating
    ``simple_df(q, x, d, interp_type)`` for STATIC q (queries) and x
    (grid times): dict of numpy arrays consumed by
    :func:`simple_df_static`. Only the three simple schemes."""
    if interp_type not in _SIMPLE_SCHEMES:
        raise LibError("simple_interp_plan: not a simple scheme "
                       + str(interp_type))
    q = np.asarray(q, np.float64)
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    tq = q + 1e-12                      # simple_df's nudge
    i = np.clip(np.searchsorted(x, tq, side="right"), 1, n - 1)
    i0 = (i - 1).astype(np.int64)
    i1 = i.astype(np.int64)
    dx = x[i1] - x[i0]
    delta = tq - x[i0]
    # jnp.interp's degenerate-interval guard, decided statically
    eps = np.spacing(np.finfo(np.float64).eps)
    dx0 = np.abs(dx) <= eps
    c = np.where(dx0, 0.0, delta / np.where(dx0, 1.0, dx))
    lo = tq < x[0]
    hi = tq > x[-1]
    i0[lo] = 0
    i1[lo] = 0
    i0[hi] = n - 1
    i1[hi] = n - 1
    c[lo | hi] = 0.0
    # exact-knot guard on the UN-nudged query (simple_df semantics)
    dist = np.abs(q[:, None] - x[None, :])
    knot_idx = np.argmin(dist, axis=1).astype(np.int64)
    at_knot = dist[np.arange(q.shape[0]), knot_idx] < 1e-10
    plan = dict(i0=i0.astype(np.int32), i1=i1.astype(np.int32), c=c,
                knot_idx=knot_idx.astype(np.int32), at_knot=at_knot,
                q=q)
    if interp_type == InterpTypes.LINEAR_ZERO_RATES:
        # r = -log(d)/x_safe with the t=0 node's rate patched to its
        # neighbour — as a static index remap (r[0] is only ever READ
        # through the gathers below)
        if x[0] == 0.0:
            plan["i0"] = np.where(plan["i0"] == 0, 1,
                                  plan["i0"]).astype(np.int32)
            plan["i1"] = np.where(plan["i1"] == 0, 1,
                                  plan["i1"]).astype(np.int32)
        plan["x_safe"] = np.maximum(x, 1e-15)
    return plan


def simple_df_static(plan: dict, dfs, interp_type: InterpTypes):
    """Evaluate a :func:`simple_interp_plan` against traced ``dfs``:
    gathers + a handful of fused elementwise ops, no searchsorted, no distance
    matrix. Returns the same values as ``simple_df(q, x, dfs)``."""
    d = jnp.asarray(dfs)
    i0, i1, c = plan["i0"], plan["i1"], plan["c"]
    if interp_type == InterpTypes.LINEAR_FWD_RATES:
        y0 = d[i0]
        val = y0 + c * (d[i1] - y0)
    elif interp_type == InterpTypes.FLAT_FWD_RATES:
        rt = -jnp.log(d)
        y0 = rt[i0]
        val = jnp.exp(-(y0 + c * (rt[i1] - y0)))
    else:                               # LINEAR_ZERO_RATES
        r = -jnp.log(d) / plan["x_safe"]
        y0 = r[i0]
        val = jnp.exp(-(y0 + c * (r[i1] - y0)) * plan["q"])
    return lax.select(plan["at_knot"], d[plan["knot_idx"]], val)


# ---------------------------------------------------------------------------
# Unified fit + eval
# ---------------------------------------------------------------------------


def interp_fit(times, dfs, interp_type: InterpTypes) -> InterpAux:
    """Precompute scheme-specific state for a curve. Pure, differentiable."""
    x = jnp.asarray(times)
    d = jnp.asarray(dfs)
    if x.size == 1 or interp_type in _SIMPLE_SCHEMES:
        return InterpAux()
    if interp_type == InterpTypes.PCHIP_LOG_DISCOUNT:
        y = jnp.log(d)
        return InterpAux(y=y, d=pchip_slopes(x, y))
    if interp_type == InterpTypes.PCHIP_ZERO_RATES:
        y = _zero_rates(x, d)
        return InterpAux(y=y, d=pchip_slopes(x, y))
    if interp_type == InterpTypes.NATCUBIC_LOG_DISCOUNT:
        y = jnp.log(d)
        return InterpAux(y=y, c=cubic_spline_coeffs(x, y))
    if interp_type == InterpTypes.NATCUBIC_ZERO_RATES:
        y = _zero_rates(x, d)
        return InterpAux(y=y, c=cubic_spline_coeffs(x, y))
    if interp_type == InterpTypes.FINCUBIC_ZERO_RATES:
        y = _zero_rates(x, d)
        return InterpAux(y=y, c=cubic_spline_coeffs(x, y,
                                                    clamped_right=True))
    raise LibError("Invalid interpolation scheme " + str(interp_type))


def interp_df(t, times, dfs, interp_type: InterpTypes,
              aux: InterpAux = None):
    """DF(t) under any scheme. ``aux`` from :func:`interp_fit` (required for
    PCHIP/cubic; recomputed on the fly if omitted).

    Single-element queries are padded to two elements internally
    (docs/f64_notes.md rule 2).
    """
    t = jnp.asarray(t)
    x = jnp.asarray(times)
    scalar = (t.ndim == 0)
    tt = jnp.atleast_1d(t)
    padded = tt.shape[0] == 1
    if padded:
        tt = jnp.concatenate([tt, tt])

    if interp_type in _SIMPLE_SCHEMES:
        out = simple_df(tt, x, dfs, interp_type)
    else:
        if aux is None or (aux.d is None and aux.c is None):
            aux = interp_fit(x, dfs, interp_type)
        if interp_type == InterpTypes.PCHIP_LOG_DISCOUNT:
            out = jnp.exp(hermite_eval(tt, x, aux.y, aux.d))
        elif interp_type == InterpTypes.PCHIP_ZERO_RATES:
            out = jnp.exp(-tt * hermite_eval(tt, x, aux.y, aux.d))
        elif interp_type == InterpTypes.NATCUBIC_LOG_DISCOUNT:
            out = jnp.exp(cubic_eval(tt, x, aux.c))
        else:  # zero-rate cubics
            out = jnp.exp(-tt * cubic_eval(tt, x, aux.c))
    if padded:
        out = out[:1]
    return out[0] if scalar else out


# ---------------------------------------------------------------------------
# Host-boundary bucketed query (cold-start control)
# ---------------------------------------------------------------------------

# Query-vector shape buckets for the host-facing DF query. Date-path
# valuations ask for one DF vector per schedule, and schedule lengths
# vary per trade — without bucketing every distinct length compiles a
# fresh tiny program (measured: ONE XCCY curve build triggered 274
# compiles totalling 8.5 s through jnp.interp alone). Padding the query
# to the next bucket collapses the shape space to ~a dozen programs
# shared across every curve with the same node count and scheme.
# COARSE buckets on purpose: each additional (query, node) key costs an
# XLA compile (~0.3 s on CPU)
# while padded evaluation work is microseconds — a whole model build
# should touch ≤ ~6 kernel programs.
_QUERY_BUCKETS = (4, 32, 128, 512, 2048)

# Node-axis buckets: curve grids also vary per curve (an OIS chain grid
# carries one node per coupon date), so the kernel is additionally keyed
# on a padded node count for the simple schemes. Pad nodes sit 500y+
# apart beyond the last real node with DFs chosen so the padded
# interpolation equals the unpadded clamp/extrapolation EXACTLY for any
# query before the first pad node (t_last + 500y — far past any date
# the Date type can express); the exact-knot guard can never select a
# pad node.
_NODE_BUCKETS = (64, 256, 1024)
_PAD_T = 500.0


def _pad_nodes(x: np.ndarray, d: np.ndarray, nb: int,
               interp_type: InterpTypes):
    """Clamp-exact node padding for the simple schemes (host-side)."""
    k = nb - x.shape[0]
    pad_t = x[-1] + _PAD_T * (1.0 + np.arange(k))
    if interp_type == InterpTypes.LINEAR_ZERO_RATES:
        # flat zero rate up to the FIRST pad node (== jnp.interp clamp
        # on r for every reachable query); later pad nodes reuse pad0's
        # df — bounded even for negative rates, and only reachable by
        # queries beyond t_last + 500y
        r_last = -np.log(d[-1]) / max(x[-1], 1e-15)
        pad_d = np.full(k, np.exp(-r_last * pad_t[0]))
    else:
        # FLAT_FWD (interp of rt = -log d, clamp -> rt_last -> d_last)
        # and LINEAR_FWD (interp of d, clamp -> d_last)
        pad_d = np.full(k, d[-1])
    return (np.concatenate([x, pad_t]), np.concatenate([d, pad_d]))


@partial(jax.jit, static_argnames=("interp_type",),
         compiler_options={"xla_backend_optimization_level": 0})
def _interp_df_kernel(tt, times, dfs, aux, interp_type):
    # opt level 0: this kernel evaluates in microseconds, LLVM's
    # optimizer is most of its compile cost (utils/compile_cache.py
    # BUILD_COMPILER_OPTIONS rationale)
    return interp_df(tt, times, dfs, interp_type, aux)


def interp_df_query(t, times, dfs, interp_type: InterpTypes,
                    aux: InterpAux = None):
    """DF(t) for host-boundary queries: pads ``t`` up to a shape bucket
    (duplicating the last entry — results are sliced back), pads the
    node grid to a bucket for the simple schemes (clamp-exact pads, see
    :func:`_pad_nodes`), and evaluates through ONE module-level jitted
    kernel keyed on (query bucket, node bucket, scheme). Semantically
    identical to :func:`interp_df`; exists purely so repeated date-path
    valuations with varying schedule and grid lengths reuse a handful
    of compiled programs instead of compiling per shape (cold start).
    Falls back to the direct path under tracing or
    for the fitted schemes (whose aux state is grid-exact)."""
    tracing = any(isinstance(v, jax.core.Tracer)
                  for v in (t, times, dfs))
    # pad in NUMPY when concrete: eager jnp concatenate/broadcast glue
    # ops each compile their own tiny per-shape program (measured ~45 of
    # them in one curve build)
    xp = jnp if tracing else np
    t = xp.asarray(t)
    scalar = (t.ndim == 0)
    tt = xp.atleast_1d(t)
    n = tt.shape[0]
    bucket = next((b for b in _QUERY_BUCKETS if b >= n), n)
    if bucket != n:
        tt = xp.concatenate(
            [tt, xp.broadcast_to(tt[-1:], (bucket - n,))])

    x, d = times, dfs
    if (not tracing) and interp_type in _SIMPLE_SCHEMES:
        x = np.asarray(x)
        d = np.asarray(d)
        nn = x.shape[0]
        nb = next((b for b in _NODE_BUCKETS if b >= nn), nn)
        if nb != nn:
            x, d = _pad_nodes(x, d, nb, interp_type)
    if aux is None:
        aux = interp_fit(jnp.asarray(x), jnp.asarray(d), interp_type)
    out = _interp_df_kernel(tt, x, d, aux, interp_type)[:n]
    return out[0] if scalar else out
