"""Multi-currency, multi-curve book-scale pricing.

Round-1's `book.py` prices one homogeneous OIS book against ONE curve.
This module generalizes the same design — one shared unique-time grid,
per-trade gathers, aggregate-weight AD — to the reference's full
multi-curve semantics (/root/reference/cavour/market/position/engine.py:
2639-2728 dual-curve float legs; 1411-1988 XCCY discounting):

 - a **CurveBasket** compiles a Model's curves into ONE differentiable
   function quotes -> [C, U] discount-factor grids: every OIS curve is a
   `bootstrap_ois`, every XCCY curve a `bootstrap_xccy` fed by the OIS
   grids it depends on — so basis AND rate shocks re-calibrate dependent
   curves inside the jitted graph (the reference rebuilds Python object
   graphs per scenario, models.py:507-557);
 - a **MultiBook** holds every leg of every trade as padded index rows:
   `disc`/`proj` curve ids are folded into the gather indices at compile
   time (dense index = curve_id * U + time_idx, then COMPACTED to the
   referenced (curve, time) pairs only — `basket.grid_sel`; the dense
   layout is ~4.6x oversized at flagship diversity and the grid axis is
   the risk pass's memory/matmul width), so the hot sweep is the SAME
   flat-gather kernel as the single-curve book — no runtime routing;
   the production sweep uses the COLUMN form (`ColRows`): one
   (column, weight) slot per cashflow against the per-scenario value
   vector [DF grid, forward-triple table];
 - FX conversion to the base currency is folded into the row weights;
 - fixed coupons, float forwards and notional exchanges aggregate to
   O(U + T) weights for book-level delta/gamma; capped/floored FRN
   coupons (nonlinear in the DFs) ride in a small per-slot group;
 - per-trade delta ladders come from the chain rule split: closed-form
   per-slot dPV/dDF coefficients (no AD through the [B, P] gathers)
   matmul'd with the [n_grid, N] curve jacobian — one jacfwd of the curve
   graph, not B backward passes.

Instruments: OIS, XccyBasisSwap / XccyFixFloat / XccyFixFix, FRN
(incl. cap/floor and first-fixing), Bond, ZCIS and YoY inflation swaps
(inflation curves ride the same flat grid as FACTOR rows; ratio payments
compile onto the forward-triple table).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.bootstrap import OISBootstrapPlan, bootstrap_ois
from ..ops.interpolation import interp_df, interp_fit
from ..ops.pricers import FloatLegTensor, pv_float_leg
from ..ops.xccy_bootstrap import bootstrap_xccy
from ..utils.currency import CurrencyTypes
from ..utils.error import LibError
from ..utils.global_types import InstrumentTypes, InterpTypes, SwapTypes

# Largest quote-vector size the exact third-order SPEED tower accepts
# without force=True (see make_multibook_speed_fn: past this the N^2
# forward tangents make compile and runtime impractical).
SPEED_MAX_QUOTES = 64

# Trip-axis chunk for the book-gamma quad form (see _gamma_quad_form:
# bounds the gathered [S, N, Tc] f64 temporaries under the scenario
# vmap while keeping the [N, Tc] @ [Tc, N] matmuls large). Chosen for
# the accelerator this was first tuned on; not yet derived for the H100
# (ROADMAP Speed 1.4).
_TRIP_CHUNK = 1024

# Scenario compile-shape cap for the staged region programs: region
# compile time grows with the scenario width, while four 25-scenario
# dispatches cost about what one 100-scenario dispatch does. Chunks are
# equalized (ceil(S / ceil(S / cap))) so S=100 runs 4 x 25 with zero
# padding waste. ``max_chunk`` overrides. Chosen for the accelerator this
# was first tuned on; not yet derived for the H100 (ROADMAP Speed 1.4).
_STAGED_COMPILE_CHUNK = 25


# ---------------------------------------------------------------------------
# Curve basket: the model's curves as one differentiable system
# ---------------------------------------------------------------------------


def _stack_leg_tensors(tensors: Sequence[FloatLegTensor]) -> FloatLegTensor:
    """Pad to a common payment count and stack along a leading axis (for
    vmapped valuation of the XCCY calibration domestic legs). Static
    bool switches must agree across legs."""
    P = max(t.payment_times.shape[0] for t in tensors)

    def pad(vec, fill):
        v = np.asarray(vec, dtype=np.float64)
        out = np.full(P, fill, dtype=np.float64)
        out[:v.shape[0]] = v
        return out

    def stack(name, fill=0.0):
        return np.stack([pad(getattr(t, name), fill) for t in tensors])

    def scal(name):
        return np.array([np.float64(getattr(t, name)) for t in tensors])

    first = tensors[0]
    assert all(t.override_first == first.override_first and
               t.notional_exchange == first.notional_exchange and
               t.has_cap_floor == first.has_cap_floor for t in tensors)
    return FloatLegTensor(
        payment_times=stack("payment_times", -1.0),  # padded slots settled
        start_times=stack("start_times", 0.0),
        end_times=stack("end_times", 0.0),
        pay_alphas=stack("pay_alphas", 0.0),
        index_alphas=stack("index_alphas", 0.0),  # 0 -> fwd masked to 0
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


@dataclasses.dataclass
class _CurveSpec:
    name: str
    kind: str                      # 'ois' | 'xccy' | 'infl'
    interp_type: InterpTypes
    n_quotes: int
    offset: int                    # slice start in the packed quote vector
    dom_id: int = -1               # xccy only: domestic curve id
    for_id: int = -1               # xccy only: foreign curve id
    foreign_interp_type: InterpTypes = None


class CurveBasket:
    """Compiles a Model's OIS + XCCY + inflation curves into one
    differentiable quotes->grids function over a packed quote vector.

    Curve order: OIS curves first (model insertion order), then XCCY
    curves (which consume the OIS grids), then inflation curves (closed
    form, no dependencies). ``specs[i].offset`` locates curve i's quotes
    inside the packed vector. Inflation curve rows hold cumulative
    FACTORS (1+r)^T on the shared time grid instead of discount factors
    (/root/reference/cavour/market/curves/inflation_curve.py:246-301) —
    the gather/trip kernels are agnostic to what the numbers mean.
    """

    def __init__(self, model, curve_names: Optional[List[str]] = None,
                 recalibrate_xccy: bool = True):
        from ..market.curves.inflation_curve import InflationCurve
        from ..trades.rates.ois_curve import OISCurve
        from ..trades.rates.xccy_curve import XccyCurve

        explicit = curve_names is not None
        names = curve_names or [
            n for n, c in model._curves_dict.items()
            if isinstance(c, (OISCurve, XccyCurve, InflationCurve))]
        ois = [(n, model._curves_dict[n]) for n in names
               if isinstance(model._curves_dict[n], OISCurve)]
        xccy = [(n, model._curves_dict[n]) for n in names
                if isinstance(model._curves_dict[n], XccyCurve)]
        infl = [(n, model._curves_dict[n]) for n in names
                if isinstance(model._curves_dict[n], InflationCurve)]
        if not explicit:
            # canonical order BY NAME within each kind: the default
            # (model dict) order is insertion order, which under
            # Model.build_parallel is thread-COMPLETION order — two
            # processes would pack quotes (and compact the grid)
            # differently, breaking cross-process artifact fingerprints
            # (a second process saw n_grid 11,339 vs the first's 11,340).
            # Explicit curve_names keep caller order.
            ois.sort(key=lambda nc: nc[0])
            xccy.sort(key=lambda nc: nc[0])
            infl.sort(key=lambda nc: nc[0])

        self.model = model
        self.recalibrate_xccy = recalibrate_xccy
        self.specs: List[_CurveSpec] = []
        self.curves: List[object] = []
        self._id_by_name: Dict[str, int] = {}

        params: Dict = {"ois_plans": [], "xccy": [], "infl": []}
        quotes0 = []
        offset = 0
        for name, curve in ois:
            n_q = len(curve.swap_rates)
            self.specs.append(_CurveSpec(name, "ois", curve._interp_type,
                                         n_q, offset))
            self._id_by_name[name] = len(self.curves)
            self.curves.append(curve)
            params["ois_plans"].append(curve._plan)
            quotes0.append(np.asarray(curve.swap_rates, dtype=np.float64))
            offset += n_q

        for name, curve in xccy:
            dom_name = next(n for n, c in ois
                            if c is curve._domestic_curve)
            for_name = next(n for n, c in ois
                            if c is curve._foreign_curve)
            n_q = len(curve.basis_spreads)
            self.specs.append(_CurveSpec(
                name, "xccy", curve._interp_type, n_q, offset,
                dom_id=self._id_by_name[dom_name],
                for_id=self._id_by_name[for_name],
                foreign_interp_type=curve._foreign_curve._interp_type))
            self._id_by_name[name] = len(self.curves)
            self.curves.append(curve)
            dom_it = curve._domestic_curve._dc_type
            dom_legs = _stack_leg_tensors([
                s._domestic_leg.tensor(model.value_dt, index_dc=dom_it)
                for s in curve._used_swaps])
            params["xccy"].append(dict(
                plan=curve._plan, dom_legs=dom_legs,
                spot_fx=np.float64(curve._spot_fx),
                pv_dom0=np.asarray(curve._pv_domestic, dtype=np.float64)))
            quotes0.append(np.asarray(curve.basis_spreads,
                                      dtype=np.float64))
            offset += n_q

        for name, curve in infl:
            n_q = len(curve.breakeven_rates)
            self.specs.append(_CurveSpec(name, "infl", curve._interp_type,
                                         n_q, offset))
            self._id_by_name[name] = len(self.curves)
            self.curves.append(curve)
            params["infl"].append(dict(
                swap_times=np.asarray(curve.swap_times, dtype=np.float64)))
            quotes0.append(np.asarray(curve.breakeven_rates,
                                      dtype=np.float64))
            offset += n_q

        params["ois_plans"] = tuple(params["ois_plans"])
        params["xccy"] = tuple(params["xccy"])
        params["infl"] = tuple(params["infl"])
        self.params = params
        self.quotes0 = np.concatenate(quotes0) if quotes0 \
            else np.zeros(0)
        self.n_quotes = offset
        self.n_curves = len(self.curves)
        # grid-axis metadata; populated by grids_fn (identity until a
        # compaction selection is installed by compile_multibook)
        self.grid_sel = None
        self.n_grid = None

    def curve_id(self, name: str) -> int:
        return self._id_by_name[name]

    def quote_slice(self, name: str) -> slice:
        spec = self.specs[self._id_by_name[name]]
        return slice(spec.offset, spec.offset + spec.n_quotes)

    # ------------------------------------------------------------------

    def native_grids_fn(self):
        """Pure fn (qvec, params) -> list of per-curve (times, dfs)."""
        specs = list(self.specs)
        recal = self.recalibrate_xccy
        dom_interp = [None] * len(specs)
        for i, s in enumerate(specs):
            if s.kind == "xccy":
                dom_interp[i] = specs[s.dom_id].interp_type

        def native(qvec, P):
            grids = []
            xccy_i = 0
            infl_i = 0
            for i, spec in enumerate(specs):
                q = lax.dynamic_slice(qvec, (spec.offset,),
                                      (spec.n_quotes,))
                if spec.kind == "ois":
                    ts, ds = bootstrap_ois(q, P["ois_plans"][i])
                elif spec.kind == "infl":
                    # closed-form factor curve (1+r)^T with the t=0 node
                    # (inflation_curve.py _build_curve_ad parity)
                    st = P["infl"][infl_i]["swap_times"]
                    infl_i += 1
                    ts = jnp.concatenate([jnp.zeros(1, st.dtype), st])
                    ds = jnp.concatenate(
                        [jnp.ones(1, st.dtype), jnp.power(1.0 + q, st)])
                else:
                    xp = P["xccy"][xccy_i]
                    xccy_i += 1
                    dom_ts, dom_ds = grids[spec.dom_id]
                    for_ts, for_ds = grids[spec.for_id]
                    if recal:
                        d_it = dom_interp[i]
                        pv_dom = jax.vmap(
                            lambda lt: pv_float_leg(
                                dom_ds, dom_ts, d_it, lt))(xp["dom_legs"])
                    else:
                        pv_dom = xp["pv_dom0"]
                        for_ts = lax.stop_gradient(for_ts)
                        for_ds = lax.stop_gradient(for_ds)
                    ts, ds = bootstrap_xccy(
                        q, pv_dom, for_ts, for_ds, xp["spot_fx"],
                        xp["plan"],
                        foreign_interp_type=spec.foreign_interp_type)
                grids.append((ts, ds))
            return grids
        return native

    def grids_fn(self, unique_times, batch_curves: bool = True,
                 stage_buckets: str = "fine", grid_sel=None):
        """Pure fn (qvec, params) -> flat DF vector over the book's grid
        axis: every curve interpolated over the shared unique-time grid,
        rows concatenated in curve-id order (dense global index =
        curve_id * U + time_idx).

        ``grid_sel`` (optional sorted int array into the dense [C*U]
        axis): emit only the selected (curve, time) pairs — the grid
        COMPACTION compile_multibook applies after harvesting which
        pairs the book's index tables actually reference (the dense
        layout is ~4.6x oversized at flagship diversity, and the grid
        axis is the risk pass's memory/matmul width). Sets
        ``self.grid_sel/n_grid/grid_inv/grid_keep_of/grid_offsets`` for
        consumers that need to recover per-curve rows
        (structured_risk's per-stage placements, pertrade_blocks'
        restricted row maps).

        ``batch_curves=True`` (default) builds the graph with one
        vmapped bootstrap per GROUP of same-topology curves instead of
        one unrolled subgraph per curve — ~3x fewer HLO ops, and the
        risk programs' compile time grows with the op count (see
        parallel/curve_batching.py). Results match the unbatched path
        to f64 noise (test_curve_batching.py).

        ``stage_buckets``: OIS shape-bucket coarseness — "fine"
        (default: quotes to multiples of 8) keeps tangent padding
        minimal; "coarse" (quotes to 32, points to 256) merges
        mixed-pillar-count models into fewer vmapped stages, trading
        padded per-member tangent work for fewer stage TRACES in every
        risk program (cold-compile control; see curve_batching.py)."""
        ut = np.asarray(unique_times)
        U = ut.shape[0]
        C = self.n_curves
        if grid_sel is None:
            grid_sel = np.arange(C * U, dtype=np.int32)
        grid_sel = np.asarray(grid_sel, dtype=np.int32)
        self.grid_sel = grid_sel
        self.n_grid = int(grid_sel.shape[0])
        self._grid_dense = self.n_grid == C * U
        # gather-based inverse (dense index -> compact position, with
        # unreferenced entries pointing at an appended zero slot) — a
        # GATHER re-expansion, never an f64 scatter
        inv = np.full(C * U, self.n_grid, dtype=np.int32)
        inv[grid_sel] = np.arange(self.n_grid, dtype=np.int32)
        self.grid_inv = inv
        self.grid_curve_of = (grid_sel // U).astype(np.int32)
        self.grid_local_of = (grid_sel % U).astype(np.int32)
        self.grid_keep_of = [self.grid_local_of[self.grid_curve_of == c]
                             for c in range(C)]
        self.grid_offsets = np.concatenate(
            [[0], np.cumsum([k.shape[0] for k in self.grid_keep_of])]
        ).astype(np.int32)

        def _select(flat):
            if self._grid_dense:
                return flat
            return jnp.take(flat, jnp.asarray(grid_sel), axis=0)

        if batch_curves:
            from .curve_batching import build_batched_grids
            dense_grids, bat, stages = build_batched_grids(
                self, ut, stage_buckets=stage_buckets)
            self.params = dict(self.params, unique_times=ut, bat=bat)
            self._stages = stages

            def grids(qvec, P):
                return _select(dense_grids(qvec, P))

            return grids

        native_fn = self.native_grids_fn()
        its = [s.interp_type for s in self.specs]

        def grids(qvec, P):
            native = native_fn(qvec, P)
            rows = []
            for (ts, ds), it in zip(native, its):
                aux = interp_fit(ts, ds, it)
                rows.append(interp_df(P["unique_times"], ts, ds, it, aux))
            return _select(jnp.concatenate(rows))

        self.params = dict(self.params, unique_times=ut)
        return grids


# ---------------------------------------------------------------------------
# Multi-book tensors
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MultiBookRows:
    """One pad-bucket of legs ("rows"): [R, P] padded index/amount arrays
    with GLOBAL gather indices (curve id folded in at compile time).
    FX-to-base and leg signs are folded into the amount weights."""
    fix_idx: jnp.ndarray             # [R, P] int32 into the compact grid
    fix_payments: jnp.ndarray        # [R, P]
    fix_mask: jnp.ndarray            # [R, P]
    flt_pay_idx: jnp.ndarray         # [R, P] int32 (disc curve)
    flt_start_idx: jnp.ndarray       # [R, P] int32 (proj curve)
    flt_end_idx: jnp.ndarray         # [R, P] int32 (proj curve)
    flt_pay_alphas: jnp.ndarray      # [R, P]
    flt_index_alphas: jnp.ndarray    # [R, P]
    flt_spreads: jnp.ndarray         # [R, P]
    flt_notionals: jnp.ndarray       # [R, P] signed, fx-folded
    flt_mask: jnp.ndarray            # [R, P]
    row_trade: jnp.ndarray           # [R] int32 owning trade

    @property
    def num_rows(self) -> int:
        return self.fix_idx.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ClampSlots:
    """Cap/floor-clamped float coupons (nonlinear in the DFs): kept
    per-slot. PV = w * clip((df_s/df_e - 1)/ia + spread, floor, cap)
    * df_p, with w = sign * fx * alpha * notional."""
    s_idx: jnp.ndarray               # [K] int32
    e_idx: jnp.ndarray               # [K] int32
    p_idx: jnp.ndarray               # [K] int32
    ia: jnp.ndarray                  # [K] index-basis alphas
    w: jnp.ndarray                   # [K]
    spread: jnp.ndarray              # [K]
    cap: jnp.ndarray                 # [K]
    floor: jnp.ndarray               # [K]
    slot_trade: jnp.ndarray          # [K] int32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ColRows:
    """One pad-bucket of legs in COLUMN form: every cashflow is a single
    (column, weight) slot against the per-scenario value vector
    v = concat(dfs_flat [n_grid], tripvals [T]) where
    tripvals[t] = (df_s/df_e - 1) * df_p over the aggregate's
    deduplicated forward triples. Fixed coupons and float spread terms
    point at DF columns; float forward terms point at trip columns. The
    hot sweep is then ONE [R, L] gather + weighted row-sum instead of
    four gathers + forward arithmetic per slot — the same PV, ~4x less
    gather traffic (the per-triple forward work happens once in the tiny
    [T] table, not once per trade)."""
    col_idx: jnp.ndarray             # [R, L] int32 into [n_grid + T]
    w: jnp.ndarray                   # [R, L] (0.0 = dead slot)
    row_trade: jnp.ndarray           # [R] int32 owning trade


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MultiBookAggregate:
    """The book's TOTAL base-ccy PV collapsed onto the compact flat grid:
    linear weights + deduplicated forward triples (+ clamp slots handled
    separately). U and T stay tiny regardless of book size, so the whole
    book's delta ladder and gamma matrix cost one trade's."""
    w_lin: jnp.ndarray               # [n_grid]
    trip_s: jnp.ndarray              # [T] int32
    trip_e: jnp.ndarray              # [T] int32
    trip_p: jnp.ndarray              # [T] int32
    trip_w: jnp.ndarray              # [T]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TileSpec:
    """Lazy tiling: the book is ``base x n_copies`` with per-copy
    notional multipliers, expanded to full row tensors ON DEVICE inside
    the jitted kernels. Only the base book (MBs, not GBs) crosses the
    host->device boundary — at 100k trades the materialized row tensors
    are ~800 MB; the expansion itself is a cheap broadcast in device
    memory and the downstream gather sweep does the identical full-size
    work."""
    scale: jnp.ndarray               # [n_copies] notional multipliers
    base_trades: int = dataclasses.field(metadata=dict(static=True))


@dataclasses.dataclass
class MultiBook:
    """A compiled multi-currency book: pad-bucketed rows + clamp slots +
    aggregate + the basket that produced the gather indices. When
    ``tile`` is set, buckets/clamp hold the BASE book and kernels expand
    in-graph (aggregate is already at tiled scale)."""
    basket: CurveBasket
    unique_times: np.ndarray
    buckets: Tuple[MultiBookRows, ...]
    clamp: Optional[ClampSlots]
    aggregate: MultiBookAggregate
    n_trades: int
    base_currency: CurrencyTypes
    tile: Optional[TileSpec] = None
    cols: Tuple[ColRows, ...] = ()   # column form of `buckets` (same PVs)


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------


class _Interner:
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
        order = np.argsort(np.asarray(self._times))
        remap = np.empty(len(order), dtype=np.int64)
        remap[order] = np.arange(len(order))
        return np.asarray(self._times)[order], remap


_DEFAULT_OIS = {
    CurrencyTypes.GBP: "GBP_OIS_SONIA",
    CurrencyTypes.USD: "USD_OIS_SOFR",
    CurrencyTypes.EUR: "EUR_OIS_ESTR",
    CurrencyTypes.JPY: "JPY_OIS_TONAR",
    CurrencyTypes.CHF: "CHF_OIS_SARON",
    CurrencyTypes.AUD: "AUD_OIS_AONIA",
    CurrencyTypes.CAD: "CAD_OIS_CORRA",
}


def _fx_to_base(model, ccy: CurrencyTypes, base: CurrencyTypes) -> float:
    if ccy == base:
        return 1.0
    return model.fx(f"{ccy.name}{base.name}")


def _float_row(tensor: FloatLegTensor, disc_id: int, proj_id: int,
               fx: float, trade_id: int, clamp_rows: list):
    """Compile a FloatLegTensor into one row dict (+ optional clamp
    slots). Exchanges and first-fixing coupons move to the FIX side."""
    sign = float(tensor.leg_sign)
    w = fx * sign
    pay_t = np.asarray(tensor.payment_times, dtype=np.float64)
    start_t = np.asarray(tensor.start_times, dtype=np.float64)
    end_t = np.asarray(tensor.end_times, dtype=np.float64)
    pay_a = np.asarray(tensor.pay_alphas, dtype=np.float64)
    idx_a = np.asarray(tensor.index_alphas, dtype=np.float64)
    spreads = np.asarray(tensor.spreads, dtype=np.float64)
    notionals = np.asarray(tensor.notionals, dtype=np.float64)
    n = pay_t.shape[0]

    fix_t, fix_amt, fix_m = [], [], []
    flt = dict(pay=[], s=[], e=[], pa=[], ia=[], sp=[], no=[], m=[])

    for j in range(n):
        live = pay_t[j] > 0.0
        amt_extra = float(tensor.principal) if j == n - 1 else 0.0
        if tensor.override_first and j == 0:
            # known fixing: the coupon is a fixed cashflow
            rate = float(tensor.first_fixing_rate) + spreads[j]
            if tensor.has_cap_floor:
                rate = min(max(rate, float(tensor.floor_rate)),
                           float(tensor.cap_rate))
            fix_t.append(pay_t[j])
            fix_amt.append(w * (rate * pay_a[j] * notionals[j] + amt_extra))
            fix_m.append(1.0 if live else 0.0)
            continue
        if amt_extra:
            fix_t.append(pay_t[j])
            fix_amt.append(w * amt_extra)
            fix_m.append(1.0 if live else 0.0)
        if tensor.has_cap_floor:
            if live:
                clamp_rows.append(dict(
                    s=(proj_id, start_t[j]), e=(proj_id, end_t[j]),
                    p=(disc_id, pay_t[j]), ia=idx_a[j],
                    w=w * pay_a[j] * notionals[j], spread=spreads[j],
                    cap=float(tensor.cap_rate),
                    floor=float(tensor.floor_rate), trade=trade_id))
            continue
        flt["pay"].append(pay_t[j])
        flt["s"].append(start_t[j])
        flt["e"].append(end_t[j])
        flt["pa"].append(pay_a[j])
        flt["ia"].append(idx_a[j])
        flt["sp"].append(spreads[j])
        flt["no"].append(w * notionals[j])
        flt["m"].append(1.0 if live else 0.0)

    if tensor.notional_exchange:
        amt = float(tensor.notional_exchange_amount)
        for t, a in [(float(tensor.effective_time), -amt),
                     (float(tensor.maturity_time), amt)]:
            fix_t.append(t)
            fix_amt.append(w * a)
            fix_m.append(1.0 if t >= 0.0 else 0.0)  # exchange AT value
            #   date still settles today (direct value() parity)

    return dict(trade=trade_id, disc=disc_id, proj=proj_id,
                fix_t=fix_t, fix_amt=fix_amt, fix_m=fix_m, flt=flt)


def _fixed_row(payment_times, amounts, disc_id: int, fx: float, sign: float,
               trade_id: int, extra_exchanges=None):
    """Fixed cashflows (+ optional (time, amount) exchanges with >= 0
    liveness)."""
    w = fx * sign
    fix_t = [float(t) for t in payment_times]
    fix_amt = [w * float(a) for a in amounts]
    fix_m = [1.0 if t > 0.0 else 0.0 for t in fix_t]
    for t, a in (extra_exchanges or []):
        fix_t.append(float(t))
        fix_amt.append(w * float(a))
        fix_m.append(1.0 if t >= 0.0 else 0.0)
    return dict(trade=trade_id, disc=disc_id, proj=disc_id,
                fix_t=fix_t, fix_amt=fix_amt, fix_m=fix_m,
                flt=dict(pay=[], s=[], e=[], pa=[], ia=[], sp=[], no=[],
                         m=[]))


def _infl_curve_id(basket: CurveBasket, inst) -> int:
    """The basket id of the instrument's inflation curve (the index's
    attached curve, else the single inflation curve in the basket —
    engine_inflation._curves_for semantics)."""
    from ..market.curves.inflation_curve import InflationCurve

    curve = inst._inflation_index._inflation_curve
    if curve is not None:
        for i, c in enumerate(basket.curves):
            if c is curve:
                return i
    cands = [i for i, c in enumerate(basket.curves)
             if isinstance(c, InflationCurve)]
    if len(cands) != 1:
        raise LibError("Inflation trade needs its index's curve in the "
                       "basket (or exactly one inflation curve)")
    return cands[0]


def _infl_payment(num_ref, den_ref, base_cpi: float, w: float,
                  spread: float, pay_t: float, row: dict):
    """Append ONE inflation-ratio payment  w·(cpi_num/cpi_den − 1 +
    spread)·df(pay)  to a row dict, splitting it into the book's
    linear/trip primitives (engine_inflation parity: cpi = fixed value
    when the lagged date has a historical fixing, else
    seas·base_cpi·factor(t)).

    Future/future ratios are the trip form (F_num/F_den − 1)·df exactly;
    a fixed side degrades the trip to the inflation curve's t=0 column
    (factor == 1 there by construction), so one kernel shape covers all
    four fixed/projected cases. Refs are (is_fixed, value, t, seas)."""
    n_fixed, n_val, n_t, n_seas = num_ref
    d_fixed, d_val, d_t, d_seas = den_ref

    if n_fixed and d_fixed:
        row["fix_t"].append(float(pay_t))
        row["fix_amt"].append(w * (n_val / d_val - 1.0 + spread))
        row["fix_m"].append(1.0)
        return
    if d_fixed:                   # k·F(n_t), k = seas·base/fixed_den
        k = n_seas * base_cpi / d_val
        s_t, e_t = float(n_t), 0.0
    elif n_fixed:                 # k/F(d_t)
        k = n_val / (d_seas * base_cpi)
        s_t, e_t = 0.0, float(d_t)
    else:                         # k·F(n_t)/F(d_t)
        k = n_seas / d_seas
        s_t, e_t = float(n_t), float(d_t)
    w_trip = w * k                          # on (F_s/F_e − 1)·df_p
    w_lin = w * (k - 1.0 + spread)          # on df_p
    flt = row["flt"]
    flt["pay"].append(float(pay_t))
    flt["s"].append(s_t)
    flt["e"].append(e_t)
    flt["pa"].append(1.0)
    flt["ia"].append(1.0)
    flt["sp"].append(w_lin / w_trip)
    flt["no"].append(w_trip)
    flt["m"].append(1.0)


def _rows_for_instrument(inst, model, basket: CurveBasket, base, value_dt,
                         trade_id: int, clamp_rows: list,
                         collateral_type=None) -> list:
    """Compile one instrument into row dicts. Cites the reference
    semantics each row reproduces (engine.py:2639-2728 dual-curve floats,
    1496-1520 XCCY foreign legs, 505-698 bonds, 700-984 FRNs,
    1108-1146 YoY legs, 217-503 OIS under foreign collateral)."""
    from ..market.position.engine_xccy import _float_leg_xccy_tensor, \
        find_xccy_curve
    from ..market.position.engine_credit import _bond_tensor, _frn_tensor
    from ..utils.day_count import DayCountTypes

    itype = inst.derivative_type
    rows = []

    if itype == InstrumentTypes.OIS_SWAP:
        cid = basket.curve_id(inst._floating_index.name)
        curve = basket.curves[cid]
        fx = _fx_to_base(model, inst._currency, base)

        coll_ccy = None
        if collateral_type is not None:
            from ..utils.global_types import collateral_to_currency
            coll_ccy = collateral_to_currency(collateral_type)
            if coll_ccy == inst._currency:
                coll_ccy = None

        if coll_ccy is None:
            ft = inst._fixed_leg.tensor(value_dt)
            lt = inst._float_leg.tensor(value_dt, index_dc=curve._dc_type)
            rows.append(_fixed_row(ft.payment_times,
                                   np.asarray(ft.payments), cid, fx,
                                   float(ft.leg_sign), trade_id))
            rows.append(_float_row(lt, cid, cid, fx, trade_id,
                                   clamp_rows))
        else:
            # OIS under foreign collateral: project on the natural OIS
            # curve, discount on the {CCY}_{COLL}_XCCY curve, whose df()
            # pins ACT/365F query times (engine parity:
            # engine._compute_ois_xccy_collateral / reference
            # engine.py:217-503). The curve graph recalibrates the XCCY
            # grid in-graph, so rate AND basis deltas carry the chain.
            from ..utils.day_count import DayCountTypes
            from ..utils.global_types import (CollateralType,
                                              get_discount_curve_name)
            disc_name = get_discount_curve_name(
                inst._currency, CollateralType[coll_ccy.name])
            if disc_name not in basket._id_by_name:
                raise LibError(
                    f"Collateralized OIS needs discount curve "
                    f"{disc_name} in the basket")
            disc_id = basket.curve_id(disc_name)
            ft = inst._fixed_leg.tensor(
                value_dt, discount_dc=DayCountTypes.ACT_365F)
            lt = inst._float_leg.tensor(
                value_dt, index_dc=curve._dc_type,
                discount_dc=DayCountTypes.ACT_365F)
            rows.append(_fixed_row(ft.payment_times,
                                   np.asarray(ft.payments), disc_id, fx,
                                   float(ft.leg_sign), trade_id))
            rows.append(_float_row(lt, disc_id, cid, fx, trade_id,
                                   clamp_rows))

    elif itype == InstrumentTypes.XCCY_SWAP:
        xname, xcurve = find_xccy_curve(model, inst)
        xid = basket.curve_id(xname)
        dom_id = basket.curve_id(inst._domestic_floating_index.name)
        for_id = basket.curve_id(inst._foreign_floating_index.name)
        dom_curve = basket.curves[dom_id]
        for_curve = basket.curves[for_id]
        fx_dom = _fx_to_base(model, inst._domestic_currency, base)
        fx_for = fx_dom * float(xcurve._spot_fx)  # foreign leg PV is in
        #   foreign ccy; trade PV converts at the curve's spot

        from ..trades.rates.swap_fixed_leg import SwapFixedLeg
        dom_leg = inst._domestic_leg
        for_leg = inst._foreign_leg

        if isinstance(dom_leg, SwapFixedLeg):
            ft = dom_leg.tensor(value_dt)
            sign = float(ft.leg_sign)
            # manual exchanges on fixed XCCY legs (engine parity:
            # xccy_fix_float_swap.py value())
            from ..utils.helpers import times_from_dates
            eff_t = times_from_dates(inst._effective_dt, value_dt,
                                     DayCountTypes.ACT_ACT_ISDA)
            mat_t = times_from_dates(inst._maturity_dt, value_dt,
                                     DayCountTypes.ACT_ACT_ISDA)
            n = inst._domestic_notional
            rows.append(_fixed_row(
                ft.payment_times, np.asarray(ft.payments), dom_id, fx_dom,
                sign, trade_id,
                extra_exchanges=[(eff_t, -n), (mat_t, n)]))
        else:
            lt = dom_leg.tensor(value_dt, index_dc=dom_curve._dc_type)
            rows.append(_float_row(lt, dom_id, dom_id, fx_dom, trade_id,
                                   clamp_rows))

        if isinstance(for_leg, SwapFixedLeg):
            from ..utils.helpers import times_from_dates
            xdc = DayCountTypes.ACT_365F
            pay_t = np.asarray(times_from_dates(
                for_leg._payment_dts, value_dt, xdc))
            sign = 1.0 if for_leg._leg_type == SwapTypes.RECEIVE else -1.0
            eff_t = times_from_dates(inst._effective_dt, value_dt, xdc)
            mat_t = times_from_dates(inst._maturity_dt, value_dt, xdc)
            n = inst._foreign_notional
            rows.append(_fixed_row(
                pay_t, np.asarray(for_leg._payments), xid, fx_for, sign,
                trade_id, extra_exchanges=[(eff_t, -n), (mat_t, n)]))
        else:
            lt = _float_leg_xccy_tensor(for_leg, value_dt,
                                        for_curve._dc_type)
            rows.append(_float_row(lt, xid, for_id, fx_for, trade_id,
                                   clamp_rows))

    elif itype == InstrumentTypes.FRN:
        disc_name = _DEFAULT_OIS[inst._currency]
        disc_id = basket.curve_id(disc_name)
        proj_id = basket.curve_id(inst._floating_index.name)
        idx_curve = basket.curves[proj_id]
        fx = _fx_to_base(model, inst._currency, base)
        lt = _frn_tensor(inst, value_dt, index_dc=idx_curve._dc_type)
        rows.append(_float_row(lt, disc_id, proj_id, fx, trade_id,
                               clamp_rows))

    elif itype == InstrumentTypes.BOND:
        disc_name = _DEFAULT_OIS[inst._currency]
        disc_id = basket.curve_id(disc_name)
        fx = _fx_to_base(model, inst._currency, base)
        ft = _bond_tensor(inst, value_dt)
        amounts = np.asarray(ft.payments, dtype=np.float64).copy()
        amounts[-1] += float(ft.principal)
        rows.append(_fixed_row(ft.payment_times, amounts, disc_id, fx,
                               1.0, trade_id))

    elif itype in (InstrumentTypes.ZCIS,
                   InstrumentTypes.YOY_INFLATION_SWAP):
        from ..market.position.engine_inflation import _cpi_ref
        from ..utils.helpers import times_from_dates

        index = inst._inflation_index
        ccy = index._currency
        disc_id = basket.curve_id(_DEFAULT_OIS[ccy])
        infl_id = _infl_curve_id(basket, inst)
        infl_curve = basket.curves[infl_id]
        base_cpi = float(infl_curve._base_cpi)
        fx = _fx_to_base(model, ccy, base)

        if itype == InstrumentTypes.ZCIS:
            # single exchange (engine_inflation.compute_zcis):
            # fixed N[(1+r)^T − 1] vs inflation N[I_T/I_b − 1], both
            # discounted at the ACT/365F payment time
            if inst._payment_dt > value_dt:
                pay_t = times_from_dates(inst._payment_dt, value_dt,
                                         DayCountTypes.ACT_365F)
                fixed_sign = -1.0 if inst._fixed_leg_type == SwapTypes.PAY \
                    else 1.0
                yf = inst.year_frac()
                fixed_amt = inst._notional \
                    * ((1.0 + inst._fixed_rate) ** yf - 1.0)
                row = dict(trade=trade_id, disc=disc_id, proj=infl_id,
                           fix_t=[float(pay_t)],
                           fix_amt=[fx * fixed_sign * fixed_amt],
                           fix_m=[1.0],
                           flt=dict(pay=[], s=[], e=[], pa=[], ia=[],
                                    sp=[], no=[], m=[]))
                b_ref = _cpi_ref(index, infl_curve, inst._effective_dt,
                                 value_dt)
                f_ref = _cpi_ref(index, infl_curve, inst._maturity_dt,
                                 value_dt)
                _infl_payment(f_ref, b_ref, base_cpi,
                              fx * (-fixed_sign) * inst._notional, 0.0,
                              pay_t, row)
                rows.append(row)
        else:
            # YoY: periodic fixed leg + YoY ratio leg
            # (engine_inflation.compute_yoy_iis / reference
            # engine.py:1108-1146)
            ft = inst._fixed_leg.tensor(value_dt)
            rows.append(_fixed_row(ft.payment_times,
                                   np.asarray(ft.payments), disc_id, fx,
                                   float(ft.leg_sign), trade_id))
            leg = inst._inflation_leg
            sign = 1.0 if leg._leg_type == SwapTypes.RECEIVE else -1.0
            row = dict(trade=trade_id, disc=disc_id, proj=infl_id,
                       fix_t=[], fix_amt=[], fix_m=[],
                       flt=dict(pay=[], s=[], e=[], pa=[], ia=[], sp=[],
                                no=[], m=[]))
            for i in range(len(leg._payment_dts)):
                if leg._payment_dts[i] <= value_dt:
                    continue
                s_ref = _cpi_ref(index, infl_curve, leg._yoy_start_dts[i],
                                 value_dt)
                e_ref = _cpi_ref(index, infl_curve, leg._yoy_end_dts[i],
                                 value_dt)
                pay_t = times_from_dates(leg._payment_dts[i], value_dt,
                                         leg._dc_type)
                w = fx * sign * float(leg._notional) \
                    * float(leg._year_fracs[i])
                _infl_payment(e_ref, s_ref, base_cpi, w,
                              float(leg._spread), pay_t, row)
            rows.append(row)

    else:
        raise LibError(f"MultiBook does not support {itype}")

    return rows


def compile_multibook(instruments, model,
                      base_currency: CurrencyTypes = CurrencyTypes.GBP,
                      curve_names: Optional[List[str]] = None,
                      n_buckets: int = 4,
                      recalibrate_xccy: bool = True,
                      collateral_types: Optional[Sequence] = None,
                      batch_curves: bool = True,
                      stage_buckets: str = "fine"
                      ) -> MultiBook:
    """Compile a heterogeneous multi-currency book against a Model.

    Returns a MultiBook whose rows gather from the COMPACTED flat DF
    vector produced by ``basket.grids_fn`` (only the (curve, time) pairs
    the book references); all PVs are in ``base_currency``.

    ``collateral_types``: optional per-trade CollateralType list (None
    entries = natural collateral). An OIS whose collateral currency
    differs from its own discounts on the {CCY}_{COLL}_XCCY curve.

    ``stage_buckets``: "fine" (default) or "coarse" — OIS stage-group
    shape-bucket coarseness, see CurveBasket.grids_fn.
    """
    from ..utils.observability import timed

    if collateral_types is not None \
            and len(collateral_types) != len(instruments):
        raise LibError("collateral_types must parallel instruments")

    basket = CurveBasket(model, curve_names,
                         recalibrate_xccy=recalibrate_xccy)
    value_dt = model.value_dt

    clamp_rows: list = []
    rows: list = []
    with timed("multibook.compile", trades=len(instruments),
               curves=basket.n_curves):
        for t_id, inst in enumerate(instruments):
            coll = collateral_types[t_id] if collateral_types else None
            rows += _rows_for_instrument(inst, model, basket,
                                         base_currency, value_dt, t_id,
                                         clamp_rows,
                                         collateral_type=coll)

    intern = _Interner()
    intern.add(0.0)

    # First pass: intern every (time) once; rows store temp indices.
    def tmp_idx(t):
        return intern.add(t)

    for r in rows:
        r["fix_ti"] = [tmp_idx(t) for t in r["fix_t"]]
        r["flt_pi"] = [tmp_idx(t) for t in r["flt"]["pay"]]
        r["flt_si"] = [tmp_idx(t) for t in r["flt"]["s"]]
        r["flt_ei"] = [tmp_idx(t) for t in r["flt"]["e"]]
    for c in clamp_rows:
        c["si"] = tmp_idx(c["s"][1])
        c["ei"] = tmp_idx(c["e"][1])
        c["pi"] = tmp_idx(c["p"][1])

    unique_times, remap = intern.finish()
    U = unique_times.shape[0]

    def gidx(curve_id, tmp):
        return curve_id * U + int(remap[tmp])

    # Bucket rows by padded length.
    def row_size(r):
        return max(len(r["fix_ti"]),
                   len(r["flt_pi"]), 1)

    order = np.argsort([row_size(r) for r in rows], kind="stable")
    n = len(rows)
    bounds = np.linspace(0, n, min(n_buckets, n) + 1).astype(int)
    spans = []
    sizes_sorted = [row_size(rows[i]) for i in order]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi <= lo:
            continue
        pad = max(sizes_sorted[lo:hi])
        if spans and spans[-1][2] == pad:
            spans[-1] = (spans[-1][0], hi, pad)
        else:
            spans.append((lo, hi, pad))

    buckets = []
    for lo, hi, P in spans:
        sel = [rows[i] for i in order[lo:hi]]
        R = len(sel)
        arr = dict(
            fix_idx=np.zeros((R, P), dtype=np.int32),
            fix_payments=np.zeros((R, P)),
            fix_mask=np.zeros((R, P)),
            flt_pay_idx=np.zeros((R, P), dtype=np.int32),
            flt_start_idx=np.zeros((R, P), dtype=np.int32),
            flt_end_idx=np.zeros((R, P), dtype=np.int32),
            flt_pay_alphas=np.zeros((R, P)),
            flt_index_alphas=np.zeros((R, P)),
            flt_spreads=np.zeros((R, P)),
            flt_notionals=np.zeros((R, P)),
            flt_mask=np.zeros((R, P)),
            row_trade=np.zeros(R, dtype=np.int32))
        for k, r in enumerate(sel):
            arr["row_trade"][k] = r["trade"]
            nf = len(r["fix_ti"])
            arr["fix_idx"][k, :nf] = [gidx(r["disc"], t)
                                      for t in r["fix_ti"]]
            arr["fix_payments"][k, :nf] = r["fix_amt"]
            arr["fix_mask"][k, :nf] = r["fix_m"]
            nl = len(r["flt_pi"])
            arr["flt_pay_idx"][k, :nl] = [gidx(r["disc"], t)
                                          for t in r["flt_pi"]]
            arr["flt_start_idx"][k, :nl] = [gidx(r["proj"], t)
                                            for t in r["flt_si"]]
            arr["flt_end_idx"][k, :nl] = [gidx(r["proj"], t)
                                          for t in r["flt_ei"]]
            arr["flt_pay_alphas"][k, :nl] = r["flt"]["pa"]
            arr["flt_index_alphas"][k, :nl] = r["flt"]["ia"]
            arr["flt_spreads"][k, :nl] = r["flt"]["sp"]
            arr["flt_notionals"][k, :nl] = r["flt"]["no"]
            arr["flt_mask"][k, :nl] = r["flt"]["m"]
        buckets.append(MultiBookRows(**arr))

    clamp = None
    if clamp_rows:
        clamp = ClampSlots(
            s_idx=np.array([gidx(c["s"][0], c["si"]) for c in clamp_rows],
                           dtype=np.int32),
            e_idx=np.array([gidx(c["e"][0], c["ei"]) for c in clamp_rows],
                           dtype=np.int32),
            p_idx=np.array([gidx(c["p"][0], c["pi"]) for c in clamp_rows],
                           dtype=np.int32),
            ia=np.array([c["ia"] for c in clamp_rows]),
            w=np.array([c["w"] for c in clamp_rows]),
            spread=np.array([c["spread"] for c in clamp_rows]),
            cap=np.array([c["cap"] for c in clamp_rows]),
            floor=np.array([c["floor"] for c in clamp_rows]),
            slot_trade=np.array([c["trade"] for c in clamp_rows],
                                dtype=np.int32))

    # ---- grid compaction ------------------------------------------------
    # The dense [C*U] layout evaluates EVERY curve at EVERY unique time,
    # but a curve only ever serves the times its own trades reference —
    # measured 4.6x dense overhead on the flagship_v5 book (U=4,337,
    # 21.8% referenced). Since the [chunk, N, C*U] scenario jacobians are
    # both the risk pass's memory budget (the staged scenario-chunk cap) and
    # its term1/term2 matmul width, keep only the referenced (curve, time)
    # pairs: remap every index table onto the compacted axis and have
    # grids() emit the selected entries (global index order is preserved,
    # so the compact axis is still curve-major).
    used = np.zeros(basket.n_curves * U, dtype=bool)
    used[0] = True                    # dead-slot target (curve 0, t=0)
    for b in buckets:
        for nm in ("fix_idx", "flt_pay_idx", "flt_start_idx",
                   "flt_end_idx"):
            used[np.asarray(getattr(b, nm)).ravel()] = True
    if clamp is not None:
        for nm in ("s_idx", "e_idx", "p_idx"):
            used[np.asarray(getattr(clamp, nm))] = True
    grid_sel = np.flatnonzero(used).astype(np.int32)
    new_of_old = np.full(basket.n_curves * U, -1, dtype=np.int32)
    new_of_old[grid_sel] = np.arange(grid_sel.shape[0], dtype=np.int32)

    def _remap(idx):
        return new_of_old[np.asarray(idx)].astype(np.int32)

    buckets = [dataclasses.replace(
        b, fix_idx=_remap(b.fix_idx), flt_pay_idx=_remap(b.flt_pay_idx),
        flt_start_idx=_remap(b.flt_start_idx),
        flt_end_idx=_remap(b.flt_end_idx)) for b in buckets]
    if clamp is not None:
        clamp = dataclasses.replace(
            clamp, s_idx=_remap(clamp.s_idx), e_idx=_remap(clamp.e_idx),
            p_idx=_remap(clamp.p_idx))

    n_grid = int(grid_sel.shape[0])
    agg = _aggregate(buckets, n_grid)
    cols = _build_cols(buckets, agg, n_grid, n_buckets)
    basket.grids = basket.grids_fn(unique_times,
                                   batch_curves=batch_curves,
                                   stage_buckets=stage_buckets,
                                   grid_sel=grid_sel)

    return MultiBook(basket=basket, unique_times=unique_times,
                     buckets=tuple(buckets), clamp=clamp, aggregate=agg,
                     n_trades=len(instruments),
                     base_currency=base_currency, cols=cols)


def _optimal_spans(sizes_sorted: np.ndarray, k: int):
    """Partition the SORTED slot-count list into <= k contiguous spans
    minimizing total padded slots sum((hi-lo) * max_size_in_span).

    Equal-count spans (the round-2 scheme) pay 2.7x the live slot count
    on the flagship book because the longest bucket pads every row to
    its max; the DP optimum at k=8 pays 1.18x — a 2.3x cut in the PV
    sweep's gather traffic. The DP runs over DISTINCT sizes (span
    boundaries only ever sit at size changes), so it is O(d^2 k) with
    d <= max row length, independent of row count."""
    n = len(sizes_sorted)
    # distinct-size group boundaries: idx[i] = end of group i
    ends = np.flatnonzero(np.diff(sizes_sorted, append=-1)) + 1
    d = len(ends)
    starts = np.concatenate([[0], ends[:-1]])
    size_of = sizes_sorted[ends - 1]
    k = min(k, d)
    INF = float("inf")
    # best[j][g] = min padded cost covering groups [0, g) with j spans
    best = np.full((k + 1, d + 1), INF)
    best[0][0] = 0.0
    choice = np.zeros((k + 1, d + 1), dtype=np.int64)
    for j in range(1, k + 1):
        for g in range(1, d + 1):
            hi = ends[g - 1]
            for g0 in range(g):
                if best[j - 1][g0] == INF:
                    continue
                lo = starts[g0]
                c = best[j - 1][g0] + (hi - lo) * size_of[g - 1]
                if c < best[j][g]:
                    best[j][g] = c
                    choice[j][g] = g0
    spans = []
    g = d
    j = int(np.argmin(best[:, d]))
    while g > 0:
        g0 = choice[j][g]
        spans.append((int(starts[g0]), int(ends[g - 1])))
        g = g0
        j -= 1
    return spans[::-1]


def _build_cols(buckets, agg: MultiBookAggregate, CU: int,
                n_buckets: int) -> Tuple[ColRows, ...]:
    """Derive the column representation from the padded buckets: one
    (col, w) slot per live fixed coupon / spread term / forward term,
    with forward terms remapped onto the aggregate's deduplicated trip
    table (trip t's column is CU + t)."""
    uniq_key = ((agg.trip_s.astype(np.int64) * CU
                 + agg.trip_e.astype(np.int64)) * CU
                + agg.trip_p.astype(np.int64))
    # np.unique returned them sorted; searchsorted recovers trip ids
    slots = []                       # (trade, [(col, w), ...])
    for b in buckets:
        R = b.fix_idx.shape[0]
        fix_idx = np.asarray(b.fix_idx)
        fix_w = np.asarray(b.fix_payments) * np.asarray(b.fix_mask)
        pay = np.asarray(b.flt_pay_idx)
        spr_w = (np.asarray(b.flt_spreads) * np.asarray(b.flt_pay_alphas)
                 * np.asarray(b.flt_notionals) * np.asarray(b.flt_mask))
        ia = np.asarray(b.flt_index_alphas)
        pa = np.asarray(b.flt_pay_alphas)
        ratio = np.where(ia > 0.0, pa / np.where(ia > 0.0, ia, 1.0), 0.0)
        fwd_w = (np.asarray(b.flt_notionals) * ratio
                 * np.asarray(b.flt_mask))
        key = ((np.asarray(b.flt_start_idx).astype(np.int64) * CU
                + np.asarray(b.flt_end_idx).astype(np.int64)) * CU
               + pay.astype(np.int64))
        trip_col = CU + np.searchsorted(uniq_key, key)
        row_trade = np.asarray(b.row_trade)
        for k in range(R):
            s: list = []
            live = fix_w[k] != 0.0
            s += list(zip(fix_idx[k][live].tolist(),
                          fix_w[k][live].tolist()))
            live = spr_w[k] != 0.0
            s += list(zip(pay[k][live].tolist(), spr_w[k][live].tolist()))
            live = fwd_w[k] != 0.0
            s += list(zip(trip_col[k][live].tolist(),
                          fwd_w[k][live].tolist()))
            slots.append((int(row_trade[k]), s))

    order = sorted(range(len(slots)), key=lambda i: len(slots[i][1]))
    sizes_sorted = np.array([len(slots[i][1]) for i in order])
    # the column sweep's HBM traffic is proportional to PADDED slots, so
    # the sweep gets more spans than the row buckets (cheap to compile,
    # 2.3x less gather traffic on the flagship book)
    spans = _optimal_spans(sizes_sorted, max(n_buckets, 8)) \
        if len(slots) else []
    cols = []
    for lo, hi in spans:
        sel = [slots[i] for i in order[lo:hi]]
        L = max(max((len(s) for _, s in sel), default=1), 1)
        R = len(sel)
        ci = np.zeros((R, L), dtype=np.int32)
        wi = np.zeros((R, L))
        rt = np.zeros(R, dtype=np.int32)
        for k, (t, s) in enumerate(sel):
            rt[k] = t
            for j, (c, w) in enumerate(s):
                ci[k, j] = c
                wi[k, j] = w
        cols.append((ci, wi, rt))
    return tuple(ColRows(col_idx=c, w=w, row_trade=r) for c, w, r in cols)


def _trip_values(dfs_flat, agg: MultiBookAggregate):
    """The [T] forward-triple value table for the column sweep."""
    return ((dfs_flat[agg.trip_s] / dfs_flat[agg.trip_e] - 1.0)
            * dfs_flat[agg.trip_p])


def trade_pvs_cols(dfs_flat, cols, clamp, n_trades: int,
                   agg: MultiBookAggregate):
    """Per-trade base-ccy PVs [B] via the single-gather column sweep."""
    v = jnp.concatenate([dfs_flat, _trip_values(dfs_flat, agg)])
    out = jnp.zeros(n_trades)
    for cb in cols:
        out = out.at[cb.row_trade].add(
            jnp.sum(cb.w * v[cb.col_idx], axis=1))
    if clamp is not None:
        out = out.at[clamp.slot_trade].add(_clamp_pvs(dfs_flat, clamp))
    return out


def _expand_cols(cb: ColRows, spec: TileSpec) -> ColRows:
    n = spec.scale.shape[0]
    row_trade = (cb.row_trade[None, :]
                 + (jnp.arange(n, dtype=cb.row_trade.dtype)
                    * spec.base_trades)[:, None]).reshape(-1)
    return ColRows(
        col_idx=jnp.broadcast_to(
            cb.col_idx[None], (n,) + cb.col_idx.shape
        ).reshape((-1,) + cb.col_idx.shape[1:]),
        w=(spec.scale[:, None, None] * cb.w[None]).reshape(
            (-1,) + cb.w.shape[1:]),
        row_trade=row_trade)


def _aggregate(buckets, CU: int) -> MultiBookAggregate:
    """Collapse the linear rows to aggregate weights (host-side)."""
    w_lin = np.zeros(CU)
    ss, ee, pp, ww = [], [], [], []
    for b in buckets:
        fix_idx = np.asarray(b.fix_idx).ravel()
        fix_w = (np.asarray(b.fix_payments)
                 * np.asarray(b.fix_mask)).ravel()
        w_lin += np.bincount(fix_idx, weights=fix_w, minlength=CU)

        pay = np.asarray(b.flt_pay_idx).ravel()
        spread_w = (np.asarray(b.flt_spreads)
                    * np.asarray(b.flt_pay_alphas)
                    * np.asarray(b.flt_notionals)
                    * np.asarray(b.flt_mask)).ravel()
        w_lin += np.bincount(pay, weights=spread_w, minlength=CU)

        ia = np.asarray(b.flt_index_alphas)
        pa = np.asarray(b.flt_pay_alphas)
        scale = np.where(ia > 0.0, pa / np.where(ia > 0.0, ia, 1.0), 0.0)
        w = (np.asarray(b.flt_notionals) * scale
             * np.asarray(b.flt_mask)).ravel()
        live = w != 0.0
        ss.append(np.asarray(b.flt_start_idx).ravel()[live])
        ee.append(np.asarray(b.flt_end_idx).ravel()[live])
        pp.append(pay[live])
        ww.append(w[live])

    s = np.concatenate(ss) if ss else np.zeros(0, dtype=np.int64)
    e = np.concatenate(ee) if ee else np.zeros(0, dtype=np.int64)
    p = np.concatenate(pp) if pp else np.zeros(0, dtype=np.int64)
    w = np.concatenate(ww) if ww else np.zeros(0)
    key = (s.astype(np.int64) * CU + e) * CU + p
    uniq, inverse = np.unique(key, return_inverse=True)
    trip_w = np.bincount(inverse, weights=w)
    return MultiBookAggregate(
        w_lin=w_lin,
        trip_s=(uniq // (CU * CU)).astype(np.int32),
        trip_e=((uniq // CU) % CU).astype(np.int32),
        trip_p=(uniq % CU).astype(np.int32),
        trip_w=trip_w)


def tile_multibook(mb: MultiBook, n_copies: int,
                   notional_scale=None,
                   materialize: bool = False) -> MultiBook:
    """Scale a compiled multibook up by tiling its rows/clamp slots with
    per-copy notional multipliers (copies share schedules and curves;
    amounts differ). Trade k of copy c becomes trade c * B + k.

    Default is LAZY: the returned book keeps the base tensors plus a
    TileSpec and the kernels expand on device (see TileSpec — avoids
    shipping ~GB of tiled rows through the host->device link).
    ``materialize=True`` builds the full numpy tensors on host instead
    (required by the sharding path, which places row shards explicitly).
    """
    if notional_scale is None:
        notional_scale = np.ones(n_copies)
    scale = np.asarray(notional_scale, dtype=np.float64)
    B = mb.n_trades
    if mb.tile is not None:
        raise LibError("multibook is already lazily tiled")

    if not materialize:
        total = float(scale.sum())
        agg = MultiBookAggregate(
            w_lin=np.asarray(mb.aggregate.w_lin) * total,
            trip_s=mb.aggregate.trip_s, trip_e=mb.aggregate.trip_e,
            trip_p=mb.aggregate.trip_p,
            trip_w=np.asarray(mb.aggregate.trip_w) * total)
        return dataclasses.replace(
            mb, aggregate=agg, n_trades=B * n_copies,
            tile=TileSpec(scale=scale, base_trades=B))

    def tile(x, amount=False, trade=False):
        x = np.asarray(x)
        tiled = np.tile(x, (n_copies,) + (1,) * (x.ndim - 1))
        if amount:
            reps = np.repeat(scale, x.shape[0])
            tiled = tiled * reps.reshape((-1,) + (1,) * (x.ndim - 1))
        if trade:
            offs = np.repeat(np.arange(n_copies, dtype=np.int32) * B,
                             x.shape[0])
            tiled = tiled + offs
        return tiled

    buckets = tuple(MultiBookRows(
        fix_idx=tile(b.fix_idx),
        fix_payments=tile(b.fix_payments, amount=True),
        fix_mask=tile(b.fix_mask),
        flt_pay_idx=tile(b.flt_pay_idx),
        flt_start_idx=tile(b.flt_start_idx),
        flt_end_idx=tile(b.flt_end_idx),
        flt_pay_alphas=tile(b.flt_pay_alphas),
        flt_index_alphas=tile(b.flt_index_alphas),
        flt_spreads=tile(b.flt_spreads),
        flt_notionals=tile(b.flt_notionals, amount=True),
        flt_mask=tile(b.flt_mask),
        row_trade=tile(b.row_trade, trade=True).astype(np.int32),
    ) for b in mb.buckets)

    clamp = None
    if mb.clamp is not None:
        c = mb.clamp
        clamp = ClampSlots(
            s_idx=tile(c.s_idx).astype(np.int32),
            e_idx=tile(c.e_idx).astype(np.int32),
            p_idx=tile(c.p_idx).astype(np.int32),
            ia=tile(c.ia), w=tile(c.w, amount=True),
            spread=tile(c.spread), cap=tile(c.cap), floor=tile(c.floor),
            slot_trade=tile(c.slot_trade, trade=True).astype(np.int32))

    CU = mb.basket.n_grid
    agg = _aggregate(buckets, CU)
    cols = tuple(ColRows(
        col_idx=tile(cb.col_idx).astype(np.int32),
        w=tile(cb.w, amount=True),
        row_trade=tile(cb.row_trade, trade=True).astype(np.int32),
    ) for cb in mb.cols)

    return MultiBook(basket=mb.basket, unique_times=mb.unique_times,
                     buckets=buckets, clamp=clamp, aggregate=agg,
                     n_trades=B * n_copies,
                     base_currency=mb.base_currency, cols=cols)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _expand_rows(b: MultiBookRows, spec: TileSpec) -> MultiBookRows:
    """Materialize a lazily tiled bucket in-graph: broadcast the base
    rows n_copies times, scaling the amount fields per copy. Pure
    on-device broadcasts — nothing new crosses the host boundary."""
    n = spec.scale.shape[0]

    def rep(x):
        return jnp.broadcast_to(
            x[None], (n,) + x.shape).reshape((-1,) + x.shape[1:])

    def amt(x):
        sc = spec.scale.reshape((n,) + (1,) * x.ndim)
        return (sc * x[None]).reshape((-1,) + x.shape[1:])

    row_trade = (b.row_trade[None, :]
                 + (jnp.arange(n, dtype=b.row_trade.dtype)
                    * spec.base_trades)[:, None]).reshape(-1)
    return MultiBookRows(
        fix_idx=rep(b.fix_idx), fix_payments=amt(b.fix_payments),
        fix_mask=rep(b.fix_mask), flt_pay_idx=rep(b.flt_pay_idx),
        flt_start_idx=rep(b.flt_start_idx),
        flt_end_idx=rep(b.flt_end_idx),
        flt_pay_alphas=rep(b.flt_pay_alphas),
        flt_index_alphas=rep(b.flt_index_alphas),
        flt_spreads=rep(b.flt_spreads),
        flt_notionals=amt(b.flt_notionals),
        flt_mask=rep(b.flt_mask), row_trade=row_trade)


def _expand_clamp(c: ClampSlots, spec: TileSpec) -> ClampSlots:
    n = spec.scale.shape[0]

    def rep(x):
        return jnp.broadcast_to(
            x[None], (n,) + x.shape).reshape(-1)

    slot_trade = (c.slot_trade[None, :]
                  + (jnp.arange(n, dtype=c.slot_trade.dtype)
                     * spec.base_trades)[:, None]).reshape(-1)
    return ClampSlots(
        s_idx=rep(c.s_idx), e_idx=rep(c.e_idx), p_idx=rep(c.p_idx),
        ia=rep(c.ia), w=(spec.scale[:, None] * c.w[None, :]).reshape(-1),
        spread=rep(c.spread), cap=rep(c.cap), floor=rep(c.floor),
        slot_trade=slot_trade)


def _agg_clamp(c: Optional[ClampSlots],
               spec: Optional[TileSpec]) -> Optional[ClampSlots]:
    """Clamp slots as seen by the AGGREGATE (total-PV) graph: slot PV is
    linear in the per-copy notional scale (the clipped rate itself is
    scale-free), so the tiled book's clamp total is the base clamp with
    weights scaled by sum(scale) — no expansion needed in the risk
    pass."""
    if c is None or spec is None:
        return c
    return dataclasses.replace(c, w=c.w * jnp.sum(spec.scale))


def _device_expand(buckets, clamp, tile, cols=None):
    """Expand a lazily tiled book ON DEVICE into concrete full-size
    arrays, as a standalone jitted step at function-build time.

    Kept OUT of the pricing program on purpose: inlining the broadcast
    expansion into the 100-scenario gamma graph failed to compile on the
    accelerator this was first built for, while the identical program
    over materialized input arrays compiled and ran. The expansion itself
    is trivial and the expanded book then lives in device memory exactly
    like a host-materialized one — minus the ~GB host->device
    transfer."""
    want_cols = cols is not None
    if tile is None:
        return (buckets, clamp, cols) if want_cols else (buckets, clamp)

    @jax.jit
    def expand(bks, cl, cbs, tl):
        ebks = None if bks is None else tuple(
            _expand_rows(b, tl) for b in bks)
        ecl = _expand_clamp(cl, tl) if cl is not None else None
        ecb = None if cbs is None else tuple(
            _expand_cols(c, tl) for c in cbs)
        return ebks, ecl, ecb

    ebks, ecl, ecb = expand(buckets, clamp, cols, tile)
    return (ebks, ecl, ecb) if want_cols else (ebks, ecl)


def _combine_rows(b: MultiBookRows):
    """Scenario-invariant slot weights (memory traffic: 3 f64 + 4 int32 per
    slot in the sweep instead of 8 f64 + 4 int32)."""
    w_fix = b.fix_payments * b.fix_mask
    ia = b.flt_index_alphas
    ratio = jnp.where(ia > 0.0,
                      b.flt_pay_alphas / jnp.where(ia > 0.0, ia, 1.0),
                      0.0)
    w_fwd = ratio * b.flt_notionals * b.flt_mask
    w_spr = b.flt_spreads * b.flt_pay_alphas * b.flt_notionals * b.flt_mask
    return w_fix, w_fwd, w_spr


def _row_pvs(dfs_flat, b: MultiBookRows, combined):
    w_fix, w_fwd, w_spr = combined
    fix_pv = jnp.sum(w_fix * dfs_flat[b.fix_idx], axis=1)
    df_s = dfs_flat[b.flt_start_idx]
    df_e = dfs_flat[b.flt_end_idx]
    df_p = dfs_flat[b.flt_pay_idx]
    cf = w_fwd * (df_s / df_e - 1.0) + w_spr
    return fix_pv + jnp.sum(cf * df_p, axis=1)


def _clamp_pvs(dfs_flat, c: ClampSlots):
    df_s = dfs_flat[c.s_idx]
    df_e = dfs_flat[c.e_idx]
    df_p = dfs_flat[c.p_idx]
    fwd = jnp.where(c.ia > 0.0, (df_s / df_e - 1.0)
                    / jnp.where(c.ia > 0.0, c.ia, 1.0), 0.0)
    rate = jnp.clip(fwd + c.spread, c.floor, c.cap)
    return c.w * rate * df_p


def trade_pvs(dfs_flat, mb_buckets, clamp, n_trades: int, combined=None):
    """Per-trade base-ccy PVs [B] from a flat DF vector."""
    if combined is None:
        combined = [_combine_rows(b) for b in mb_buckets]
    out = jnp.zeros(n_trades)
    for b, comb in zip(mb_buckets, combined):
        rpv = _row_pvs(dfs_flat, b, comb)
        out = out.at[b.row_trade].add(rpv)
    if clamp is not None:
        out = out.at[clamp.slot_trade].add(_clamp_pvs(dfs_flat, clamp))
    return out


def aggregate_total(dfs_flat, agg: MultiBookAggregate,
                    clamp: Optional[ClampSlots]):
    """Total book PV — O(U + T + K) regardless of trade count."""
    lin = jnp.sum(agg.w_lin * dfs_flat)
    trip = jnp.sum(agg.trip_w
                   * (dfs_flat[agg.trip_s] / dfs_flat[agg.trip_e] - 1.0)
                   * dfs_flat[agg.trip_p])
    total = lin + trip
    if clamp is not None:
        total = total + jnp.sum(_clamp_pvs(dfs_flat, clamp))
    return total


def _gamma_quad_form(J, dfs_flat, agg: MultiBookAggregate,
                     clamp: Optional[ClampSlots]):
    """Closed-form Jᵀ·H_agg·J where H_agg = ∂²(aggregate_total)/∂dfs² and
    J is the [N, C*U] curve jacobian (tangent per ROW).

    The aggregate's Hessian w.r.t. the DF vector is sparse by
    construction: the linear part contributes nothing, each forward
    triple v = (a/b - 1)·c (a=df_s, b=df_e, c=df_p) contributes a 3x3
    block, and each clamp slot a 3x3 block gated by its in-range
    indicator. Rather than scattering blocks into a [C*U, C*U] matrix
    (an f64 scatter), the
    quadratic form contracts gathered J columns directly:
        Σ_t w_t f_xy(t) · J[:,x_t] ⊗ J[:,y_t]  =  (w f_xy ⊙ J_x) @ J_yᵀ
    — dense [N, T] @ [T, N] matmuls, no scatter anywhere. This is
    the same split the reference hand-assembles per trade
    (/root/reference/cavour/market/position/engine.py:2563-2568), done
    once for the whole book.

    The trip axis is CHUNKED via lax.map past _TRIP_CHUNK slots: the
    gathered J columns are ~6 concurrent [S, N, T] f64 temporaries
    under the scenario vmap. At flagship_v5 trip counts (T=4,643),
    chunks of 1,024 bound those temporaries ~4.5x below the unchunked
    size while keeping the matmuls large; zero-padded tail slots
    contribute exactly zero (w=0)."""
    T = int(agg.trip_s.shape[0])

    def _trip_part(idx_s, idx_e, idx_p, w):
        a = dfs_flat[idx_s]
        b = dfs_flat[idx_e]
        c = dfs_flat[idx_p]
        Ja = J[:, idx_s]             # [N, Tc]
        Jb = J[:, idx_e]
        Jc = J[:, idx_p]
        # second partials of (a/b - 1) c:  f_aa = f_cc = 0
        f_ab = -c / (b * b)
        f_ac = 1.0 / b
        f_bb = 2.0 * a * c / (b * b * b)
        f_bc = -a / (b * b)
        Z = (Ja * (w * f_ab)[None, :]) @ Jb.T
        Z = Z + (Ja * (w * f_ac)[None, :]) @ Jc.T
        Z = Z + (Jb * (w * f_bc)[None, :]) @ Jc.T
        Z = Z + Z.T                  # symmetrize the asymmetric pairs
        return Z + (Jb * (w * f_bb)[None, :]) @ Jb.T

    if T <= _TRIP_CHUNK:
        G = _trip_part(agg.trip_s, agg.trip_e, agg.trip_p, agg.trip_w)
    else:
        pad = (-T) % _TRIP_CHUNK

        def pad_to(x, fill):
            return jnp.concatenate(
                [x, jnp.full((pad,), fill, x.dtype)]).reshape(
                    -1, _TRIP_CHUNK)

        parts = lax.map(
            lambda t: _trip_part(t[0], t[1], t[2], t[3]),
            (pad_to(agg.trip_s, 0), pad_to(agg.trip_e, 0),
             pad_to(agg.trip_p, 0), pad_to(agg.trip_w, 0.0)))
        G = jnp.sum(parts, axis=0)

    if clamp is not None:
        G = G + _clamp_quad_form(J, dfs_flat, clamp)
    return G


def _clamp_quad_form(J, dfs_flat, clamp: ClampSlots):
    """The cap/floor slots' contribution to Jᵀ·H_agg·J.
    PV = w·clip((u/v-1)/ia + spread, lo, hi)·p; the clipped rate's
    u/v partials vanish outside the cap/floor band (kink itself is
    measure-zero, as in AD)."""
    u = dfs_flat[clamp.s_idx]
    v = dfs_flat[clamp.e_idx]
    p = dfs_flat[clamp.p_idx]
    has = clamp.ia > 0.0
    ia = jnp.where(has, clamp.ia, 1.0)
    pre = jnp.where(has, (u / v - 1.0) / ia, 0.0) + clamp.spread
    inside = ((pre > clamp.floor) & (pre < clamp.cap)) & has
    wI = clamp.w * inside.astype(u.dtype)
    Ju = J[:, clamp.s_idx]
    Jv = J[:, clamp.e_idx]
    Jp = J[:, clamp.p_idx]
    g_uv = -wI * p / (ia * v * v)
    g_up = wI / (ia * v)
    g_vp = -wI * u / (ia * v * v)
    g_vv = 2.0 * wI * p * u / (ia * v * v * v)
    Gc = (Ju * g_uv[None, :]) @ Jv.T
    Gc = Gc + (Ju * g_up[None, :]) @ Jp.T
    Gc = Gc + (Jv * g_vp[None, :]) @ Jp.T
    Gc = Gc + Gc.T
    return Gc + (Jv * g_vv[None, :]) @ Jv.T


def _term1_trip_groups(basket, agg: MultiBookAggregate):
    """Host-side signature grouping of the trip table for the quad
    form: a trip's three J columns are nonzero ONLY on the quote slots
    of the curves they belong to (plus XCCY parents when the basket
    recalibrates them in-graph), so the [N, T] @ [T, N] contraction can
    run at each group's closed quote width k instead of full N (k <= 72
    of N=184 on flagship_v5). Returns a list of dicts with static int
    index arrays (safe as closure constants; f64 WEIGHTS still route
    through the traced aggregate — docs/f64_notes.md rule 6), or None
    when the basket lacks grid metadata."""
    curve_of = getattr(basket, "grid_curve_of", None)
    if curve_of is None or agg.trip_s.shape[0] == 0:
        return None
    curve_of = np.asarray(curve_of)
    specs = basket.specs

    def contrib(cid):
        s = {int(cid)}
        sp = specs[int(cid)]
        if sp.kind == "xccy" and basket.recalibrate_xccy:
            s |= {sp.dom_id, sp.for_id}
        return s

    ts = np.asarray(agg.trip_s)
    te = np.asarray(agg.trip_e)
    tp = np.asarray(agg.trip_p)
    cs, ce, cp = curve_of[ts], curve_of[te], curve_of[tp]
    sig_cache: Dict[tuple, frozenset] = {}
    by_sig: Dict[frozenset, List[int]] = {}
    for t in range(ts.shape[0]):
        key = (int(cs[t]), int(ce[t]), int(cp[t]))
        sig = sig_cache.get(key)
        if sig is None:
            sig = frozenset(contrib(key[0]) | contrib(key[1])
                            | contrib(key[2]))
            sig_cache[key] = sig
        by_sig.setdefault(sig, []).append(t)

    groups = []
    for sig, tidx in sorted(by_sig.items(),
                            key=lambda kv: sorted(kv[0])):
        raw = sorted((specs[c].offset, specs[c].n_quotes) for c in sig)
        segs: List[tuple] = []
        for off, n in raw:                  # merge adjacent quote slices
            if segs and segs[-1][0] + segs[-1][1] == off:
                segs[-1] = (segs[-1][0], segs[-1][1] + n)
            else:
                segs.append((off, n))
        tsel = np.asarray(tidx, dtype=np.int32)
        groups.append(dict(
            tsel=tsel,
            s_idx=ts[tsel].astype(np.int32),
            e_idx=te[tsel].astype(np.int32),
            p_idx=tp[tsel].astype(np.int32),
            segs=tuple(segs),
            k=sum(n for _, n in segs)))
    return groups


def _gamma_quad_form_grouped(J, dfs_flat, agg: MultiBookAggregate,
                             clamp: Optional[ClampSlots], groups):
    """_gamma_quad_form restricted per signature group (see
    _term1_trip_groups): each group contracts [k, T_g] @ [T_g, k] and
    adds its block into G at the group's quote segments by contiguous
    dynamic-slice updates (never an f64 scatter). Every trip lives in
    exactly one group, so the block adds compose exactly; clamp slots
    keep the full-N closed form (K is tiny)."""
    N = J.shape[0]
    n_grid = J.shape[1]
    G = jnp.zeros((N, N), J.dtype)
    Jf = J.reshape(-1)
    for g in groups:
        s_i = jnp.asarray(g["s_idx"])
        e_i = jnp.asarray(g["e_idx"])
        p_i = jnp.asarray(g["p_idx"])
        a = dfs_flat[s_i]
        b = dfs_flat[e_i]
        c = dfs_flat[p_i]
        w = agg.trip_w[jnp.asarray(g["tsel"])]
        # ONE flat 2-D gather per operand: row-slicing J to [k, n_grid]
        # and gathering columns after materializes ~20x the needed data
        # (measured the B region's warm wall after grouping). The
        # static [k, T_g] flat index tables fetch exactly the operand.
        rows = np.concatenate([np.arange(off, off + n)
                               for off, n in g["segs"]])
        base = rows[:, None].astype(np.int64) * n_grid

        def cols(idx, base=base):
            return jnp.asarray(base + np.asarray(idx)[None, :])

        Ja = Jf[cols(g["s_idx"])]           # [k, T_g]
        Jb = Jf[cols(g["e_idx"])]
        Jc = Jf[cols(g["p_idx"])]
        f_ab = -c / (b * b)
        f_ac = 1.0 / b
        f_bb = 2.0 * a * c / (b * b * b)
        f_bc = -a / (b * b)
        Z = (Ja * (w * f_ab)[None, :]) @ Jb.T
        Z = Z + (Ja * (w * f_ac)[None, :]) @ Jc.T
        Z = Z + (Jb * (w * f_bc)[None, :]) @ Jc.T
        Z = Z + Z.T
        Z = Z + (Jb * (w * f_bb)[None, :]) @ Jb.T
        lo1 = 0
        for off1, n1 in g["segs"]:
            lo2 = 0
            for off2, n2 in g["segs"]:
                cur = lax.dynamic_slice(G, (off1, off2), (n1, n2))
                G = lax.dynamic_update_slice(
                    G, cur + Z[lo1:lo1 + n1, lo2:lo2 + n2],
                    (off1, off2))
                lo2 += n2
            lo1 += n1
    if clamp is not None:
        G = G + _clamp_quad_form(J, dfs_flat, clamp)
    return G


def _scenario_risk(grids, qvec_shocked, P, agg, clamp_agg, want_gamma):
    """Delta + (optionally) gamma for ONE scenario via the chain-rule
    split:

        delta = J @ g,
        gamma = Jᵀ·H_agg·J  +  Σ_k g_k · ∂²dfs_k/∂q∂q

    with J = ∂dfs/∂q computed by ONE jacfwd of the curve graph (shared
    by delta, the quad form, and nothing else), g = ∂total/∂dfs one
    cheap backward of the O(U+T+K) aggregate, and the curve-Hessian
    term one jacfwd∘grad of the scalar g₀·dfs(q) — the double
    differentiation never touches the aggregate sweep, whose batched
    f64 scatter-add transpose under N tangents dominated the plain
    jacfwd∘jacrev tower."""
    dfs, jvp_fn = jax.linearize(lambda q: grids(q, P), qvec_shocked)
    N = qvec_shocked.shape[0]
    J = jax.vmap(jvp_fn)(jnp.eye(N, dtype=qvec_shocked.dtype))  # [N, C*U]
    g = jax.grad(lambda d: aggregate_total(d, agg, clamp_agg))(dfs)
    out = {"delta": J @ g, "dfs": dfs}
    if want_gamma:
        term1 = _gamma_quad_form(J, dfs, agg, clamp_agg)
        g0 = lax.stop_gradient(g)
        term2 = jax.jacfwd(
            jax.grad(lambda q: jnp.dot(g0, grids(q, P))))(qvec_shocked)
        out["gamma"] = term1 + term2
    return out


def _trade_row_table(mb: MultiBook) -> np.ndarray:
    """Static [B, K] row-gather table over the concatenated per-bucket
    row-PV vector (bucket-major; within a lazily tiled bucket the
    in-graph expansion is copy-major, row index c*R_b + r — see
    _expand_cols). Dead slots point at the appended zero row R_total."""
    base_R = [cb.col_idx.shape[0] for cb in mb.cols]
    offs = np.cumsum([0] + list(base_R))
    if mb.tile is not None:
        n_cop = int(mb.tile.scale.shape[0])
        B_base = int(mb.tile.base_trades)
        offs = np.cumsum([0] + [R * n_cop for R in base_R])
    else:
        n_cop = 1
        B_base = mb.n_trades
    R_total = int(offs[-1])

    rows_of: List[list] = [[] for _ in range(B_base)]
    for bi, cb in enumerate(mb.cols):
        rt = np.asarray(cb.row_trade)
        for r in range(rt.shape[0]):
            rows_of[int(rt[r])].append((int(offs[bi]) + r, base_R[bi]))
    K = max((len(x) for x in rows_of), default=1)
    base_idx = np.full((B_base, K), R_total, dtype=np.int64)
    stride = np.zeros((B_base, K), dtype=np.int64)
    for t, lst in enumerate(rows_of):
        for k, (gidx, rb) in enumerate(lst):
            base_idx[t, k] = gidx
            stride[t, k] = rb
    if n_cop == 1:
        return base_idx.astype(np.int32)
    copies = np.arange(n_cop, dtype=np.int64)
    idx = (base_idx[None, :, :]
           + copies[:, None, None] * stride[None, :, :])
    return idx.reshape(n_cop * B_base, K).astype(np.int32)


def _pvs_sweep(dfs_all, cbs, cl, ag, tri):
    """Per-trade PV sweep over all scenarios at once.

    TRANSPOSED sweep: per-scenario gathers fetch one f64 scalar per
    slot (~5.6M random scalar reads x S on the flagship — the gather
    unit's descriptor rate bounds the sweep). Transposing the value
    table to [M, S] makes each slot's gather fetch a CONTIGUOUS
    S-element row (800 B at S=100): the slot count stays the same but
    every descriptor moves 100x the payload, and the scenario loop
    disappears from the sweep entirely. Module-level jit: every book
    shares one dispatch cache (shapes key the compiles)."""
    S = dfs_all.shape[0]
    trip_all = jax.vmap(lambda d: _trip_values(d, ag))(dfs_all)
    vT = jnp.concatenate([dfs_all, trip_all], axis=1).T   # [M, S]
    rowpvs = []
    for cb in cbs:
        R, L = cb.col_idx.shape
        # bound the [chunk*L, S] gathered temporary near 200 MB f64
        chunk = max(1, min(R, int(2.5e7 // max(L * S, 1))))
        pad = (-R) % chunk
        ci, wi = cb.col_idx, cb.w
        if pad:
            ci = jnp.concatenate(
                [ci, jnp.zeros((pad, L), ci.dtype)])
            wi = jnp.concatenate(
                [wi, jnp.zeros((pad, L), wi.dtype)])

        def one_chunk(args, S=S):
            c, w = args
            Y = vT[c.reshape(-1)].reshape(c.shape + (S,))
            # multiply+sum, NOT einsum: "rl,rls->rs" lowers to a
            # batch of [1, L] @ [L, S] micro-matmuls (701 ms vs
            # 105 ms measured for the flagship sweep at S=100)
            return jnp.sum(w[:, :, None] * Y, axis=1)

        out = lax.map(one_chunk, (ci.reshape(-1, chunk, L),
                                  wi.reshape(-1, chunk, L)))
        rowpvs.append(out.reshape(-1, S)[:R])
    rowpv = jnp.concatenate(
        rowpvs + [jnp.zeros((1, S), dfs_all.dtype)])
    pvs_bs = jnp.sum(rowpv[tri], axis=1)                  # [B, S]
    if cl is not None:
        dT = dfs_all.T
        df_s = dT[cl.s_idx]
        df_e = dT[cl.e_idx]
        df_p = dT[cl.p_idx]
        has = (cl.ia > 0.0)[:, None]
        ia = jnp.where(cl.ia > 0.0, cl.ia, 1.0)[:, None]
        fwd = jnp.where(has, (df_s / df_e - 1.0) / ia, 0.0)
        rate = jnp.clip(fwd + cl.spread[:, None],
                        cl.floor[:, None], cl.cap[:, None])
        pvs_bs = pvs_bs.at[cl.slot_trade].add(
            cl.w[:, None] * rate * df_p)
    return pvs_bs.T


_pvs_program = jax.jit(_pvs_sweep)


def make_multibook_fn(mb: MultiBook, want_gamma: bool = True):
    """Jitted (qvec, shocks [S, N]) -> {pvs [S, B], delta [S, N],
    gamma [S, N, N]}: per-trade PVs from the gather sweep (streamed
    scenario-by-scenario), book delta/gamma from the aggregate graph.
    N is the packed quote dimension across EVERY curve (OIS rates +
    basis spreads), so the gamma includes all cross-curve blocks."""
    basket = mb.basket
    grids = basket.grids
    params = jax.device_put(basket.params)
    cols = jax.device_put(mb.cols)
    clamp = jax.device_put(mb.clamp) if mb.clamp is not None else None
    agg = jax.device_put(mb.aggregate)
    clamp_agg = _agg_clamp(clamp, mb.tile)
    _, clamp, cols = _device_expand(None, clamp, mb.tile, cols=cols)
    n_trades = mb.n_trades

    CU = basket.n_grid
    N = basket.n_quotes

    # TWO jitted programs, not one: the monolithic
    # sweep+delta+gamma program is the largest compile in the package —
    # splitting halves the compile's peak memory and lets each half hit
    # the persistent compile cache independently.
    #
    # Scenario batching: NEVER a plain scenario-sequential lax.map — a
    # known-trip-count loop whose body is the whole pricing/risk graph
    # failed to compile at S=100 on the accelerator this was first built
    # for (suspected full loop unrolling), while the same graph vmapped,
    # or lax.map'ed with a batch_size, compiled and ran. The risk pass
    # vmaps up to a memory-bounded batch (its [batch, N, C*U] tangent
    # temporaries must fit); the PV sweep uses a small batch (its
    # per-bucket gather temporaries are [batch, R, P]-sized).
    # Per-trade aggregation as a GATHER, not a scatter: rows of one trade
    # are found via a static [B, K] row-index table (K = max legs/trade,
    # dead slots point at an appended zero row); the gather table
    # replaces ~R scatter-adds per scenario with B*K contiguous gathers.
    # Clamp slots keep the scatter — they are few.
    trade_rows_idx = jnp.asarray(_trade_row_table(mb))

    _pvs = _pvs_program

    @jax.jit
    def _dfs_only(qvec, P, shocks):
        return jax.vmap(lambda s: grids(qvec + s, P))(shocks)

    # cap the vmapped tangent temporaries near ~1.5 GB of f64: the
    # closed-form split holds TWO [batch, N, C*U] tangent stacks live
    # (J and the curve-Hessian contraction's jacfwd). The 1e8-element
    # budget was chosen for a 16 GB accelerator; not yet derived for the
    # H100 (ROADMAP Speed 1.4).
    risk_batch = max(1, min(int(1e8 // max(N * CU, 1)), 64))

    # structured per-stage differentiation (parallel/structured_risk.py)
    # whenever the basket carries the batched stage topology: the
    # block-sparse quote->curve dependency makes it ~4x less tangent
    # work than the generic full-graph split, and the per-stage programs
    # compile far faster than one 184-tangent monolith.
    structured = None
    if getattr(basket, "_stages", None) is not None:
        from .structured_risk import make_structured_risk
        structured = make_structured_risk(basket,
                                          host_agg=mb.aggregate)
        # the structured pass holds ~3 [batch, N, n_grid] f64 arrays
        # live (J, term1 gathers, per-stage tangent stacks are smaller);
        # larger scenario batches amortize per-op dispatch overhead.
        # 2.5 GB budget (vs the staged regions' 6 GB): this MONOLITH
        # composes term2 under the same vmap as J, and its per-stage
        # tangent towers add [batch, Qp, G, U] temporaries the staged
        # split schedules in separate programs. Both budgets were sized
        # for a 16 GB accelerator; not yet derived for the H100 (ROADMAP
        # Speed 1.4).
        risk_batch = max(1, min(int(2.5e9 // max(N * CU * 8 * 3, 1)),
                                128))

    @jax.jit
    def _risk(qvec, P, ag, cl_agg, shocks):
        if not want_gamma:
            # delta alone is ONE backward pass — cheaper than the
            # N-tangent jacfwd the closed-form split needs for J.
            def one_scenario(shock):
                dfs = grids(qvec + shock, P)
                total = lambda q: aggregate_total(grids(q, P), ag, cl_agg)
                return {"delta": jax.jacrev(total)(qvec + shock),
                        "dfs": dfs}
        elif structured is not None:
            def one_scenario(shock):
                return structured(qvec + shock, P, ag, cl_agg, True)
        else:
            def one_scenario(shock):
                return _scenario_risk(grids, qvec + shock, P, ag, cl_agg,
                                      True)

        return lax.map(one_scenario, shocks,
                       batch_size=min(risk_batch, shocks.shape[0]))

    def fn(qvec, shocks):
        qvec = jnp.asarray(qvec)
        shocks = jnp.asarray(shocks)
        out = _risk(qvec, params, agg, clamp_agg, shocks)
        # the risk pass already bootstrapped every scenario's grids —
        # the PV sweep consumes them instead of recomputing
        dfs_all = out.pop("dfs")
        out["pvs"] = _pvs(dfs_all, cols, clamp, agg, trade_rows_idx)
        return out

    # phase-attribution hooks: call the two compiled programs separately
    def _risk_only(qvec, shocks):
        out = _risk(jnp.asarray(qvec), params, agg, clamp_agg,
                    jnp.asarray(shocks))
        out.pop("dfs", None)
        return out

    fn.risk_only = _risk_only
    fn.pvs_only = lambda qvec, shocks: _pvs(
        _dfs_only(jnp.asarray(qvec), params, jnp.asarray(shocks)),
        cols, clamp, agg, trade_rows_idx)
    return fn


def make_staged_multibook_fn(mb: MultiBook, want_gamma: bool = True,
                             max_chunk: Optional[int] = None):
    """(qvec, shocks [S, N]) -> {pvs [S, B], delta [S, N],
    gamma [S, N, N]} — the same outputs as make_multibook_fn, computed
    through independently-compiled REGION programs instead of one
    monolithic jit:

        A   fwd+J+delta   (structured_risk fwd_delta, vmapped)
        B   term1         (trip-table quad form over A's J)
        C1  term2, XCCY stages (curve hessians + parent cotangents)
        C2  term2, OIS/inflation stages (consume C1's cotangents)
        D   gamma = t1 + h2_xccy + h2_ois
        P   per-trade PV sweep over A's DF grids

    Why: the flagship monolith is the largest compile in the package
    and XLA compiles one program serially.
    ``fn.precompile(n_scenarios, parallel=True)`` lowers and compiles
    the regions in concurrent threads and keeps the returned
    EXECUTABLES — ``jit(...).lower().compile()`` does NOT seed the jit
    dispatch cache, so dispatching through the kept handles is what
    makes the first real call pay zero compile. Whether the concurrent
    compile and the split pay on the H100 is not measured yet (ROADMAP
    Speed 1.7).

    Scenario batching: chunks of ``min(memory-bounded cap, S)`` are
    sliced and zero-padded on the HOST in numpy (an eager device op
    would be a compile of its own), so a single-chunk call dispatches
    exactly the five programs and nothing else.

    Requires the basket's batched stage topology (batch_curves=True).
    ``want_gamma=False`` runs A+P only. ``max_chunk`` overrides the
    memory-derived scenario chunk cap (tests exercise the multi-chunk
    path with it)."""
    basket = mb.basket
    if getattr(basket, "_stages", None) is None:
        raise LibError(
            "make_staged_multibook_fn requires the batched stage "
            "topology: compile the book with batch_curves=True")
    from .structured_risk import make_structured_parts
    parts = make_structured_parts(basket, host_agg=mb.aggregate)
    fwd_delta = parts["fwd_delta"]
    term1 = parts["term1"]
    term2_xccy = parts["term2_xccy"]
    term2_ois = parts["term2_ois"]

    params = jax.device_put(basket.params)
    cols = jax.device_put(mb.cols)
    clamp = jax.device_put(mb.clamp) if mb.clamp is not None else None
    agg = jax.device_put(mb.aggregate)
    clamp_agg = _agg_clamp(clamp, mb.tile)
    _, clamp, cols = _device_expand(None, clamp, mb.tile, cols=cols)
    trade_rows_idx = jnp.asarray(_trade_row_table(mb))

    CU = basket.n_grid
    N = basket.n_quotes
    dt = np.asarray(basket.quotes0).dtype
    # memory budget (~3 [chunk, N, n_grid] f64 live; 6e9 bytes, chosen
    # for a 16 GB accelerator and not yet derived for the H100, ROADMAP
    # Speed 1.4) AND the compile-shape cap (see _STAGED_COMPILE_CHUNK)
    chunk_cap = max(1, min(int(6e9 // max(N * CU * 8 * 3, 1)),
                           _STAGED_COMPILE_CHUNK, 128))
    if max_chunk is not None:
        chunk_cap = int(max_chunk)

    def _chunk_for(S: int) -> int:
        """Equalized chunk: smallest count of <=chunk_cap-sized chunks,
        then even sizes (S=100, cap 25 -> 4 x 25, no padding waste)."""
        n_ch = -(-S // chunk_cap)
        return -(-S // n_ch)

    @jax.jit
    def _A(qvec, P, ag, cl_agg, shocks):
        return jax.vmap(
            lambda s: fwd_delta(qvec + s, P, ag, cl_agg))(shocks)

    @jax.jit
    def _B(J, dfs, ag, cl_agg):
        return jax.vmap(lambda j, d: term1(j, d, ag, cl_agg))(J, dfs)

    # term2 splits at its natural cut — XCCY-stage hessians produce the
    # parent cotangents (C1), OIS-stage hessians consume them (C2) — so
    # the largest region compile halves into two concurrent programs.
    @jax.jit
    def _C1(qvec, P, g, carry, shocks):
        return jax.vmap(
            lambda gi, ci, s: term2_xccy(qvec + s, P, gi, ci))(
                g, carry, shocks)

    @jax.jit
    def _C2(qvec, P, g, v_of, shocks):
        return jax.vmap(
            lambda gi, vi, s: term2_ois(qvec + s, P, gi, vi))(
                g, v_of, shocks)

    @jax.jit
    def _D(t1, h2x, h2o):
        return t1 + h2x + h2o

    execs: Dict[str, object] = {}
    state = {"chunk": None, "S": None}

    def _run_chunk(qvec, sh):
        use = execs if sh.shape[0] == state["chunk"] else {}
        def call(name, jit_fn, *args):
            return use[name](*args) if name in use else jit_fn(*args)

        a = call("A", _A, qvec, params, agg, clamp_agg, sh)
        res = {"delta": a["delta"], "dfs": a["dfs"]}
        if want_gamma:
            t1 = call("B", _B, a["J"], a["dfs"], agg, clamp_agg)
            h2x, v_of = call("C1", _C1, qvec, params, a["g"],
                             a["carry"], sh)
            h2o = call("C2", _C2, qvec, params, a["g"], v_of, sh)
            res["gamma"] = call("D", _D, t1, h2x, h2o)
        return res

    def fn(qvec, shocks):
        qvec = jnp.asarray(qvec, dt)
        shocks_np = np.asarray(shocks, dt)
        S = shocks_np.shape[0]
        chunk = _chunk_for(S)
        outs = []
        for lo in range(0, S, chunk):
            sh = shocks_np[lo:lo + chunk]
            pad = chunk - sh.shape[0]
            if pad:
                sh = np.concatenate([sh, np.zeros((pad, N), dt)])
            outs.append(_run_chunk(qvec, jnp.asarray(sh)))
        if len(outs) == 1:
            res = outs[0]          # chunk == S: no pad, no concat
        else:
            res = {k: jnp.concatenate([o[k] for o in outs])[:S]
                   for k in outs[0]}
        dfs_all = res.pop("dfs")
        res["pvs"] = (execs["P"](dfs_all, cols, clamp, agg,
                                 trade_rows_idx)
                      if "P" in execs and S == state["S"]
                      else _pvs_program(dfs_all, cols, clamp, agg,
                                        trade_rows_idx))
        return res

    def precompile(n_scenarios: int, parallel: bool = True,
                   compiler_options: Optional[dict] = None):
        """AOT-compile every region program for the exact shapes a
        (n_scenarios, N)-shock call will dispatch, in parallel threads
        when ``parallel``. Keeps the executables; fn() dispatches
        through them (a later jit-path call would RE-compile —
        lower().compile() does not seed the jit dispatch cache).

        ``compiler_options`` passes through to every region's XLA
        compile. Keep the default (no options, full optimization) unless
        measuring something new: lowering the optimization effort once
        bought no compile time and cost 6x at runtime."""
        from concurrent.futures import ThreadPoolExecutor

        chunk = _chunk_for(int(n_scenarios))

        def sds(t):
            return jax.tree_util.tree_map(
                lambda x: jax.ShapeDtypeStruct(jnp.shape(x),
                                               jnp.result_type(x)), t)

        import time

        qv = jax.ShapeDtypeStruct((N,), dt)
        sh = jax.ShapeDtypeStruct((chunk, N), dt)
        Ps, ags, cls = sds(params), sds(agg), sds(clamp_agg)
        # lower A once and read its output avals from the Lowered —
        # a separate eval_shape would trace the (large) region graph a
        # second time for nothing
        timings: Dict[str, float] = {}

        def lower_now(name, f, *args):
            # regions whose OUTPUT avals gate another region's lowering
            # are lowered serially here (out_info on the Lowered — a
            # separate eval_shape would trace the large graph twice)
            t0 = time.perf_counter()
            lowered = f.lower(*args)
            timings["trace_" + name] = round(time.perf_counter() - t0, 3)
            return lowered

        lowered_A = lower_now("A", _A, qv, Ps, ags, cls, sh)
        a_sh = lowered_A.out_info
        dfs_full = jax.ShapeDtypeStruct((int(n_scenarios), CU), dt)
        jobs = {"A": lowered_A,
                "P": (_pvs_program, (dfs_full, sds(cols), sds(clamp),
                                     ags, sds(trade_rows_idx)))}
        if want_gamma:
            t1_sh = jax.ShapeDtypeStruct((chunk, N, N), dt)
            lowered_C1 = lower_now("C1", _C1, qv, Ps, a_sh["g"],
                                   a_sh["carry"], sh)
            _, vof_sh = lowered_C1.out_info
            jobs["B"] = (_B, (a_sh["J"], a_sh["dfs"], ags, cls))
            jobs["C1"] = lowered_C1
            jobs["C2"] = (_C2, (qv, Ps, a_sh["g"], vof_sh, sh))
            jobs["D"] = (_D, (t1_sh, t1_sh, t1_sh))

        def build(name, item):
            t0 = time.perf_counter()
            lowered = (item if hasattr(item, "compile")
                       else item[0].lower(*item[1]))
            if compiler_options:
                compiled = lowered.compile(
                    compiler_options=compiler_options)
            else:
                compiled = lowered.compile()
            timings[name] = round(time.perf_counter() - t0, 3)
            return compiled

        if parallel:
            with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
                futs = {k: ex.submit(build, k, v)
                        for k, v in jobs.items()}
                execs.update({k: f.result() for k, f in futs.items()})
        else:
            execs.update({k: build(k, v) for k, v in jobs.items()})
        state["chunk"] = chunk
        state["S"] = int(n_scenarios)
        fn.compile_seconds = timings
        fn.chunk = chunk
        return fn

    def save_executables(path: str):
        """Serialize the kept region EXECUTABLES to ``path`` (pickle of
        jax.experimental.serialize_executable payloads + the dispatch
        state). This is a cold-start artifact: a fresh process on a
        same-topology device calls ``load_executables`` and pays
        executable loads instead of compiles (not measured on the H100;
        ROADMAP Design 3.2). Backend-specific: a payload serialized
        against one device kind will not load on another — regenerate
        per fleet."""
        import pickle

        from jax.experimental.serialize_executable import serialize

        if not execs:
            raise LibError("save_executables: precompile(...) first")
        data = {k: serialize(ex) for k, ex in execs.items()}
        blob = dict(execs=data, chunk=state["chunk"], S=state["S"],
                    n_grid=basket.n_grid, n_quotes=N,
                    want_gamma=want_gamma)
        with open(path, "wb") as f:
            pickle.dump(blob, f)

    def load_executables(path: str, device=None):
        """Load region executables saved by ``save_executables`` into
        this fn's dispatch path (shape-checked against this book).
        Returns fn, ready to call with (S, N) shocks without any XLA
        compile. The regions are single-device programs; they load onto
        ``device`` (default ``jax.devices()[0]`` — without this a
        multi-device backend would bind them across ALL local devices
        and reject single-shard args at dispatch)."""
        import pickle

        from jax.experimental.serialize_executable import \
            deserialize_and_load

        dev = device if device is not None else jax.devices()[0]
        with open(path, "rb") as f:
            blob = pickle.load(f)
        if blob["n_grid"] != basket.n_grid or blob["n_quotes"] != N \
                or blob["want_gamma"] != want_gamma:
            raise LibError(
                f"load_executables: archive was built for a different "
                f"book (n_grid {blob['n_grid']} vs {basket.n_grid}, "
                f"n_quotes {blob['n_quotes']} vs {N}, want_gamma "
                f"{blob['want_gamma']} vs {want_gamma})")
        for k, (payload, in_tree, out_tree) in blob["execs"].items():
            execs[k] = deserialize_and_load(
                payload, in_tree, out_tree,
                execution_devices=(dev,))
        state["chunk"] = blob["chunk"]
        state["S"] = blob["S"]
        return fn

    fn.precompile = precompile
    fn.save_executables = save_executables
    fn.load_executables = load_executables
    fn.programs = execs
    return fn


def make_multibook_speed_fn(mb: MultiBook, force: bool = False):
    """Jitted (qvec) -> [N, N, N] EXACT third-order book risk tensor
    speed[i, j, k] = ∂³ total_PV / ∂q_i ∂q_j ∂q_k (ccy units per
    unit-rate³; multiply by 1e-12 for per-bp³), matching the
    per-position engine SPEED measure (engine.py SPEED route) summed
    over the book.

    Implementation is the plain AD tower jacfwd∘jacfwd∘jacrev over the
    aggregate graph — NO structured shortcut, deliberately
   : the structured pass's second-order
    machinery stop-gradients the aggregate cotangent g, so
    differentiating ITS gamma would silently drop the ∂g/∂q third-order
    terms, and extending the per-stage chain rule one more level means
    hand-assembling the full Faà di Bruno composition through the XCCY
    legs/boot bottlenecks (f'''·(g')³ + 3·f''·g'·g'' + f'·g''' per
    stage pair, plus cross-parent terms) — a large, hard-to-validate
    surface for a measure with no reference implementation at all (the
    reference defines the SPEED enum but never computes it). The tower
    is exact and compiles fine at small/medium quote dims (N ≲ ~60);
    at flagship N (184) its N² forward tangents through the whole curve
    graph make compile AND runtime impractical — full-book third-order
    risk at that scale is explicitly out of scope, documented here and
    in README. Use engine-level SPEED per position for selected trades
    instead.

    Raises LibError above SPEED_MAX_QUOTES quotes unless ``force=True``
    (a flagship-size basket otherwise gets an unbounded compile, not an
    error)."""
    basket = mb.basket
    if basket.n_quotes > SPEED_MAX_QUOTES and not force:
        raise LibError(
            f"make_multibook_speed_fn: n_quotes={basket.n_quotes} > "
            f"{SPEED_MAX_QUOTES}. The exact third-order tower needs N^2 "
            f"forward tangents through the whole curve graph; past ~"
            f"{SPEED_MAX_QUOTES} quotes compile and runtime are "
            f"impractical (see docstring). Pass force=True to override, "
            f"or compute engine-level SPEED per position for selected "
            f"trades.")
    grids = basket.grids
    params = jax.device_put(basket.params)
    agg = jax.device_put(mb.aggregate)
    clamp_agg = _agg_clamp(
        jax.device_put(mb.clamp) if mb.clamp is not None else None,
        jax.device_put(mb.tile) if mb.tile is not None else None)

    @jax.jit
    def _fn(qvec, P, ag, cl_ag):
        def total(q):
            return aggregate_total(grids(q, P), ag, cl_ag)

        return jax.jacfwd(jax.jacfwd(jax.jacrev(total)))(qvec)

    def fn(qvec):
        return _fn(jnp.asarray(qvec), params, agg, clamp_agg)

    return fn


def warmup_multibook(mb: MultiBook, n_scenarios: int,
                     want_gamma: bool = True, staged: bool = False,
                     parallel: bool = True):
    """Pre-compile the book's PV-sweep and risk programs for EXACTLY the
    (n_scenarios, n_quotes) shapes a production loop will use, and return
    the ready fn. With ``adrates_tpu.configure_cache()`` active, the
    compiles land in the persistent cache: the next process skips them
    entirely.

    ``staged=True`` warms make_staged_multibook_fn instead: the region
    programs AOT-compile, concurrently with ``parallel=True``."""
    if staged:
        fn = make_staged_multibook_fn(mb, want_gamma=want_gamma)
        fn.precompile(n_scenarios, parallel=parallel)
    else:
        fn = make_multibook_fn(mb, want_gamma=want_gamma)
    shocks = np.zeros((n_scenarios, mb.basket.n_quotes))
    jax.block_until_ready(fn(jnp.asarray(mb.basket.quotes0), shocks))
    return fn


def _axis_names(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _pad_bucket(b: MultiBookRows, pad: int) -> MultiBookRows:
    """Append ``pad`` dead rows (zero weights/masks -> zero PV; trade 0
    receives +0.0). Works on numpy AND traced jnp tensors."""
    if pad == 0:
        return b

    def ext(x):
        xp = jnp if isinstance(x, jnp.ndarray) else np
        return xp.concatenate(
            [x, xp.zeros((pad,) + x.shape[1:], dtype=x.dtype)])

    return MultiBookRows(**{f.name: ext(getattr(b, f.name))
                            for f in dataclasses.fields(MultiBookRows)})


def _pad_clamp(c: ClampSlots, pad: int) -> ClampSlots:
    if pad == 0:
        return c

    def ext(x):
        xp = jnp if isinstance(x, jnp.ndarray) else np
        return xp.concatenate(
            [x, xp.zeros((pad,) + x.shape[1:], dtype=x.dtype)])

    return ClampSlots(**{f.name: ext(getattr(c, f.name))
                         for f in dataclasses.fields(ClampSlots)})


def shard_multibook(mb: MultiBook, mesh, axis="book"):
    """Place a multibook's row/clamp tensors with their leading axis
    sharded across the mesh (curve params and the aggregate replicated).

    ``axis`` may be one mesh axis name or a tuple (e.g. ("host", "book")
    on a 2-D process x chip mesh — rows shard over BOTH). Row counts
    that don't divide the shard count are padded with dead rows (zero
    weights -> zero PV) HERE, not by the caller."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    if mb.tile is not None:
        raise LibError(
            "shard_multibook places materialized rows; for a lazy "
            "TileSpec book pass the MultiBook straight to "
            "make_sharded_multibook_fn, which expands ON DEVICE into "
            "sharded rows (no full-size host array is ever built)")

    axes = _axis_names(axis)
    n_shards = int(np.prod([mesh.shape[a] for a in axes]))

    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    buckets = tuple(MultiBookRows(**{
        f.name: put(getattr(b, f.name),
                    P(axes, None) if np.asarray(
                        getattr(b, f.name)).ndim == 2 else P(axes))
        for f in dataclasses.fields(
            MultiBookRows)}) for b in (
        _pad_bucket(b, (-b.fix_idx.shape[0]) % n_shards)
        for b in mb.buckets))
    clamp = None
    if mb.clamp is not None:
        c = _pad_clamp(mb.clamp, (-mb.clamp.w.shape[0]) % n_shards)
        clamp = ClampSlots(**{
            f.name: put(getattr(c, f.name), P(axes))
            for f in dataclasses.fields(ClampSlots)})
    return dataclasses.replace(mb, buckets=buckets, clamp=clamp)


def make_sharded_multibook_fn(mb: MultiBook, mesh, axis="book",
                              want_gamma: bool = True):
    """Multibook analytics under GSPMD: rows sharded over the mesh, quote
    vector and curve graph replicated; the per-trade scatter-add and
    portfolio aggregates ride collectives inserted by XLA.

    Accepts materialized books (rows placed via ``shard_multibook`` or
    placed here) AND lazy ``TileSpec`` books: the lazy path device-puts
    only the base rows (MBs) and runs the tile expansion as a jitted
    step with SHARDED out_shardings, so the full-size row tensors exist
    only as device shards — the ~GB host->device transfer the TileSpec
    design exists to avoid never happens. On a 2-D (host, book) mesh
    pass ``axis=("host", "book")``; shocks/quotes stay replicated so the
    only cross-host traffic is the final psum."""
    from functools import partial

    from jax.sharding import NamedSharding, PartitionSpec as P

    axes = _axis_names(axis)
    n_shards = int(np.prod([mesh.shape[a] for a in axes]))
    repl = NamedSharding(mesh, P())
    row2 = NamedSharding(mesh, P(axes, None))
    row1 = NamedSharding(mesh, P(axes))

    basket = mb.basket
    grids = basket.grids
    params = jax.device_put(basket.params, repl)
    # structured per-stage risk (replicated work — only the row sweep
    # is sharded, so the same pass serves every mesh shape)
    structured = None
    if getattr(basket, "_stages", None) is not None:
        from .structured_risk import make_structured_risk
        structured = make_structured_risk(basket,
                                          host_agg=mb.aggregate)
    # aggregate carries the TILED totals already (lazy or materialized)
    agg = jax.device_put(mb.aggregate, repl)
    clamp_agg = _agg_clamp(
        jax.device_put(mb.clamp, repl) if mb.clamp is not None else None,
        jax.device_put(mb.tile, repl) if mb.tile is not None else None)
    n_trades = mb.n_trades

    row_shard = MultiBookRows(**{
        f.name: row2 if f.name != "row_trade" else row1
        for f in dataclasses.fields(MultiBookRows)})
    clamp_shard = ClampSlots(**{
        f.name: row1 for f in dataclasses.fields(ClampSlots)})

    if mb.tile is None:
        buckets = tuple(_pad_bucket(b, (-b.fix_idx.shape[0]) % n_shards)
                        for b in mb.buckets)
        clamp = mb.clamp if mb.clamp is None else _pad_clamp(
            mb.clamp, (-mb.clamp.w.shape[0]) % n_shards)
        already = getattr(mb.buckets[0].fix_idx, "sharding", None)
        if not isinstance(already, NamedSharding):
            buckets = tuple(MultiBookRows(**{
                f.name: jax.device_put(
                    getattr(b, f.name),
                    row2 if np.asarray(getattr(b, f.name)).ndim == 2
                    else row1)
                for f in dataclasses.fields(MultiBookRows)})
                for b in buckets)
            if clamp is not None:
                clamp = ClampSlots(**{
                    f.name: jax.device_put(getattr(clamp, f.name), row1)
                    for f in dataclasses.fields(ClampSlots)})
    else:
        # lazy: replicate the small base book, expand+pad in-graph with
        # sharded outputs (its own program — see _device_expand)
        base_bks = jax.device_put(mb.buckets, repl)
        base_cl = jax.device_put(mb.clamp, repl) \
            if mb.clamp is not None else None
        tile_dev = jax.device_put(mb.tile, repl)

        out_bk_shards = tuple(row_shard for _ in mb.buckets)
        out_cl_shard = clamp_shard if mb.clamp is not None else None

        @partial(jax.jit, out_shardings=(out_bk_shards, out_cl_shard))
        def expand_sharded(bks, cl, tl):
            ebks = tuple(
                _pad_bucket(eb, (-eb.fix_idx.shape[0]) % n_shards)
                for eb in (_expand_rows(b, tl) for b in bks))
            ecl = None
            if cl is not None:
                ec = _expand_clamp(cl, tl)
                ecl = _pad_clamp(ec, (-ec.w.shape[0]) % n_shards)
            return ebks, ecl

        buckets, clamp = expand_sharded(base_bks, base_cl, tile_dev)

    bucket_shardings = tuple(row_shard for _ in buckets)
    cl_sharding = None if clamp is None else clamp_shard

    # clamp_agg rides as a jit ARGUMENT, never a closure constant
    # (docs/f64_notes.md rule 6)
    @partial(jax.jit, in_shardings=(repl, repl, bucket_shardings,
                                    cl_sharding, repl, repl, repl))
    def _fn(qvec, Pp, bks, cl, ag, cl_ag, shocks):
        def one_scenario(shock):
            dfs_flat = grids(qvec + shock, Pp)
            pvs = trade_pvs(dfs_flat, bks, cl, n_trades)
            if structured is not None:
                out = structured(qvec + shock, Pp, ag, cl_ag, want_gamma)
            else:
                out = _scenario_risk(grids, qvec + shock, Pp, ag, cl_ag,
                                     want_gamma)
            out.pop("dfs", None)  # replicated grids, no reason to ship
            out["total_pv"] = jnp.sum(pvs)
            return out
        return jax.vmap(one_scenario)(shocks)

    def fn(qvec, shocks):
        return _fn(jnp.asarray(qvec), params, buckets, clamp, agg,
                   clamp_agg, jnp.asarray(shocks))

    return fn


# ---------------------------------------------------------------------------
# per-trade delta ladders
# ---------------------------------------------------------------------------


def _harvest_sel_tables(mb: MultiBook, trade_ids) -> Dict[str, np.ndarray]:
    """Host-side flat lin/trip/clamp slot tables for a SELECTION of
    (tiled) trade ids, weights at tile scale, b indices local to the
    selection order. Shared by the single-device and mesh-sharded
    per-trade gamma builders."""
    sel = np.asarray(trade_ids, dtype=np.int64)
    B_sel = sel.shape[0]
    CU = mb.basket.n_grid

    if mb.tile is not None:
        B_base = mb.tile.base_trades
        mult = np.asarray(mb.tile.scale)[sel // B_base]
        rows_of = sel % B_base
    else:
        mult = np.ones(B_sel)
        rows_of = sel

    # host-side slot harvest for the selected trades
    agg = mb.aggregate
    lin, trip, clamp_sl = [], [], []
    # duplicate base rows (same base trade selected in several copies)
    # need one entry per SELECTION, not per base trade
    sel_of_base: Dict[int, list] = {}
    for k, t in enumerate(rows_of):
        sel_of_base.setdefault(int(t), []).append(k)

    for cb in mb.cols:
        ci = np.asarray(cb.col_idx)
        w = np.asarray(cb.w)
        rt = np.asarray(cb.row_trade)
        for r in np.nonzero(np.isin(rt, rows_of))[0]:
            for k in sel_of_base[int(rt[r])]:
                live = w[r] != 0.0
                cols = ci[r][live]
                ws = w[r][live] * mult[k]
                is_trip = cols >= CU
                for c, wv in zip(cols[~is_trip], ws[~is_trip]):
                    lin.append((k, int(c), float(wv)))
                for c, wv in zip(cols[is_trip], ws[is_trip]):
                    t_i = int(c) - CU
                    trip.append((k, int(agg.trip_s[t_i]),
                                 int(agg.trip_e[t_i]),
                                 int(agg.trip_p[t_i]), float(wv)))
    if mb.clamp is not None:
        c = mb.clamp
        st = np.asarray(c.slot_trade)
        for r in np.nonzero(np.isin(st, rows_of))[0]:
            for k in sel_of_base[int(st[r])]:
                clamp_sl.append((k, int(c.s_idx[r]), int(c.e_idx[r]),
                                 int(c.p_idx[r]), float(c.ia[r]),
                                 float(c.w[r]) * mult[k],
                                 float(c.spread[r]), float(c.cap[r]),
                                 float(c.floor[r])))

    lin_arr = np.asarray(lin, dtype=np.float64).reshape(-1, 3)
    trip_arr = np.asarray(trip, dtype=np.float64).reshape(-1, 5)
    cl_arr = np.asarray(clamp_sl, dtype=np.float64).reshape(-1, 9)

    T = dict(
        lin_b=lin_arr[:, 0].astype(np.int32),
        lin_c=lin_arr[:, 1].astype(np.int32),
        lin_w=lin_arr[:, 2],
        tr_b=trip_arr[:, 0].astype(np.int32),
        tr_s=trip_arr[:, 1].astype(np.int32),
        tr_e=trip_arr[:, 2].astype(np.int32),
        tr_p=trip_arr[:, 3].astype(np.int32),
        tr_w=trip_arr[:, 4],
        cl_b=cl_arr[:, 0].astype(np.int32),
        cl_s=cl_arr[:, 1].astype(np.int32),
        cl_e=cl_arr[:, 2].astype(np.int32),
        cl_p=cl_arr[:, 3].astype(np.int32),
        cl_ia=cl_arr[:, 4], cl_w=cl_arr[:, 5], cl_sp=cl_arr[:, 6],
        cl_cap=cl_arr[:, 7], cl_lo=cl_arr[:, 8])

    # ---- grouped quad-form pair tables --------------------------------
    # The trade-Hessian quad form is a sum of w_pair * J_col1 (x) J_col2
    # outer products. Grouped BY TRADE with pad slots, the whole sum is
    # B batched [N, K] @ [K, N] matmuls instead of a [P, N, N]
    # per-slot outer-product temporary + scatter-add (20+ GB at flagship
    # slot counts; a chunked-scatter fallback writes ~100s of GB).
    #
    # Pair-weight indexing is SLOT-MAJOR (idx = 1 + 4*slot + kind, the
    # device interleaves the four kind vectors per slot) and SPLIT per
    # slot family (trip / clamp), so zero-padding the flat slot tables
    # to a common length — the mesh-sharded builder stacks shards that
    # way — never moves a live index: pad slots append at the end with
    # w=0. Index 0 is a dummy zero weight so K-padding with zeros is
    # inert. Self-pairs (bb / vv) carry 0.5 so the final Z + Z^T
    # symmetrization restores them exactly.
    def grouped(b_idx, c_triples):
        ents: List[list] = [[] for _ in range(B_sel)]
        for i in range(b_idx.shape[0]):
            b = int(b_idx[i])
            (x1, y1), (x2, y2), (x3, y3), (x4, y4) = c_triples(i)
            ents[b] += [(1 + 4 * i + 0, x1, y1), (1 + 4 * i + 1, x2, y2),
                        (1 + 4 * i + 2, x3, y3), (1 + 4 * i + 3, x4, y4)]
        K = max([len(x) for x in ents] + [1])
        gq = np.zeros((3, B_sel, K), np.int32)
        for b, lst in enumerate(ents):
            if lst:
                gq[:, b, :len(lst)] = np.asarray(lst, np.int32).T
        return gq

    def trip_pairs(i):
        s, e, p = int(T["tr_s"][i]), int(T["tr_e"][i]), int(T["tr_p"][i])
        return (s, e), (s, p), (e, p), (e, e)        # ab, ac, bc, bb/2

    def clamp_pairs(i):
        u, v, p = int(T["cl_s"][i]), int(T["cl_e"][i]), int(T["cl_p"][i])
        return (u, v), (u, p), (v, p), (v, v)        # uv, up, vp, vv/2

    gqt = grouped(T["tr_b"], trip_pairs)
    gqc = grouped(T["cl_b"], clamp_pairs)
    T["gqt_w"], T["gqt_c1"], T["gqt_c2"] = gqt[0], gqt[1], gqt[2]
    T["gqc_w"], T["gqc_c1"], T["gqc_c2"] = gqc[0], gqc[1], gqc[2]
    return T


def _sel_gamma_kernel(basket, B_sel: int):
    """(qvec, P, tables) -> [B_sel, N, N] exact selected-trade gamma
    body (traceable; jitted by the single-device builder, shard_mapped
    by the sharded one). The chain-rule split is the book gamma's:

        gamma_b = Jᵀ·H_b·J + Σ_k g_bk · ∂²dfs_k/∂q∂q

    H_b (the trade's own DF-space Hessian) is closed form over its trip
    and clamp slots — per-trade grouped [N, K] @ [K, N] batched matmuls
    over the harvest's pair tables, no AD through the sweep; the
    curve-Hessian contraction reuses the structured per-stage
    second-order tensors (structured_risk.make_pertrade_curvehess)."""
    grids = basket.grids
    CU = basket.n_grid
    curvehess = None
    if getattr(basket, "_stages", None) is not None:
        from .structured_risk import make_pertrade_curvehess
        curvehess = make_pertrade_curvehess(basket)

    def _fn(qvec, P, tb):
        dfs, jvp_fn = jax.linearize(lambda q: grids(q, P), qvec)
        N = qvec.shape[0]
        J = jax.vmap(jvp_fn)(jnp.eye(N, dtype=qvec.dtype))   # [N, CU]

        # per-trade DF-space gradient G [B_sel, CU] (closed form)
        G = jnp.zeros((B_sel, CU))
        G = G.at[tb["lin_b"], tb["lin_c"]].add(tb["lin_w"])
        a = dfs[tb["tr_s"]]
        b_ = dfs[tb["tr_e"]]
        c_ = dfs[tb["tr_p"]]
        w = tb["tr_w"]
        G = G.at[tb["tr_b"], tb["tr_s"]].add(w * c_ / b_)
        G = G.at[tb["tr_b"], tb["tr_e"]].add(-w * a * c_ / (b_ * b_))
        G = G.at[tb["tr_b"], tb["tr_p"]].add(w * (a / b_ - 1.0))

        # second partials of (a/b - 1)·c per trip slot, interleaved
        # slot-major to match the grouped tables (idx = 1 + 4*slot +
        # kind, kinds ab/ac/bc/bb2; index 0 = dummy zero)
        f_ab = -c_ / (b_ * b_)
        f_ac = 1.0 / b_
        f_bb = 2.0 * a * c_ / (b_ * b_ * b_)
        f_bc = -a / (b_ * b_)
        w_tr = jnp.concatenate([
            jnp.zeros((1,), qvec.dtype),
            jnp.stack([w * f_ab, w * f_ac, w * f_bc, 0.5 * w * f_bb],
                      axis=1).reshape(-1)])

        Jrows = J.T                                   # [CU, N]

        def grouped_quad(Z, w_flat, wi, c1, c2):
            """Z += sum_k w_flat[wi[b,k]] * Jrows[c1] (x) Jrows[c2] as
            B batched [N, Kc] @ [Kc, N] matmuls. The per-slot
            outer-product form ([P, N, N] temporary + scatter-add) needs
            ~23 GB at flagship slot counts and its chunked-scan variant
            is memory-traffic bound; the grouped form reads each operand
            once. K chunks bound the [B, Kc, N] gathers ~200 MB f64."""
            wk = w_flat[wi]                           # [B, K]
            Kg = wk.shape[1]
            Kc = max(1, min(Kg, int(2e8 // max(B_sel * N * 8 * 2, 1))))
            for lo in range(0, Kg, Kc):
                hi = min(Kg, lo + Kc)
                X = wk[:, lo:hi, None] * Jrows[c1[:, lo:hi]]
                Y = Jrows[c2[:, lo:hi]]
                Z = Z + jnp.einsum("bkn,bkm->bnm", X, Y)
            return Z

        Z = jnp.zeros((B_sel, N, N), qvec.dtype)
        Z = grouped_quad(Z, w_tr, tb["gqt_w"], tb["gqt_c1"],
                         tb["gqt_c2"])

        if tb["cl_b"].shape[0]:
            u = dfs[tb["cl_s"]]
            v = dfs[tb["cl_e"]]
            p = dfs[tb["cl_p"]]
            has = tb["cl_ia"] > 0.0
            ia = jnp.where(has, tb["cl_ia"], 1.0)
            pre = jnp.where(has, (u / v - 1.0) / ia, 0.0) + tb["cl_sp"]
            rate = jnp.clip(pre, tb["cl_lo"], tb["cl_cap"])
            inside = ((pre > tb["cl_lo"]) & (pre < tb["cl_cap"])) & has
            wI = tb["cl_w"] * inside.astype(u.dtype)
            cb_ = tb["cl_b"]
            G = G.at[cb_, tb["cl_p"]].add(tb["cl_w"] * rate)
            G = G.at[cb_, tb["cl_s"]].add(wI * p / (ia * v))
            G = G.at[cb_, tb["cl_e"]].add(-wI * p * u / (ia * v * v))
            w_cl = jnp.concatenate([
                jnp.zeros((1,), qvec.dtype),
                jnp.stack([-wI * p / (ia * v * v), wI / (ia * v),
                           -wI * u / (ia * v * v),
                           wI * p * u / (ia * v ** 3)],
                          axis=1).reshape(-1)])
            Z = grouped_quad(Z, w_cl, tb["gqc_w"], tb["gqc_c1"],
                             tb["gqc_c2"])

        # Z + Z^T restores the symmetric pairs (self-pairs carry 0.5)
        Gm = Z + jnp.swapaxes(Z, 1, 2)

        # curve-Hessian contraction, shared machinery with the book
        # gamma: per-stage second-order tensors contracted with each
        # trade's DF-space gradient (structured_risk). The generic
        # jacfwd(jacfwd(grids)) [C*U, N, N] fallback needs N^2 tangent
        # directions through the whole curve graph — intractable at
        # flagship scale (184^2 directions; the structured path uses
        # ~3.5k, each through one small stage).
        if curvehess is not None:
            Gm = Gm + curvehess(qvec, P, G)
        else:
            H = jax.jacfwd(jax.jacfwd(
                lambda q: grids(q, P)))(qvec)             # [CU, N, N]
            N_ = H.shape[1]
            Gm = Gm + (G @ H.reshape(CU, N_ * N_)).reshape(
                B_sel, N_, N_)
        return Gm

    return _fn


def make_per_trade_gamma_fn(mb: MultiBook, trade_ids):
    """Jitted (qvec) -> [B_sel, N, N] EXACT per-trade gamma matrices for
    a selected set of trades (ccy units per unit-rate²; multiply by 1e-8
    for per-bp²), via the same chain-rule split as the book gamma
   :

        gamma_b = Jᵀ·H_b·J + Σ_k g_bk · ∂²dfs_k/∂q∂q

    H_b (the trade's own DF-space Hessian) is closed form over its trip
    and clamp slots — batched einsums, no AD through the sweep. The
    curve Hessian contraction is SHARED by every selected trade
    (structured per-stage second-order tensors when the basket carries
    the batched topology, else one jacfwd∘jacfwd of the curve graph) —
    select trades rather than asking for all 100k (a full book's
    [B, N, N] is terabytes; the reference assembles the same
    per-position shape one trade at a time, engine.py:2563-2568; for
    ALL trades use make_per_trade_gamma_blocks_fn's exact own-block
    form instead)."""
    sel = np.asarray(trade_ids, dtype=np.int64)
    params = jax.device_put(mb.basket.params)
    tables = jax.device_put(_harvest_sel_tables(mb, sel))
    _fn = jax.jit(_sel_gamma_kernel(mb.basket, sel.shape[0]))

    def fn(qvec):
        return _fn(jnp.asarray(qvec), params, tables)

    return fn


def make_per_trade_delta_fn(mb: MultiBook, chunk: int = 2048,
                            dtype=None, method: str = "gather"):
    """Jitted (qvec) -> [B, N] per-trade delta ladders (ccy units per unit
    rate; multiply by 1e-4 for per-bp), single scenario.

    Chain-rule split: per-slot dPV/dDF coefficients are CLOSED FORM (the
    same gathers as the PV sweep — no AD through the [R, P] graph), and
    the curve jacobian J = d dfs_flat / d quotes [C*U, N] is ONE jacfwd
    of the curve graph.

    ``method`` picks how the [B, N] contraction against the
    [C*U + T, N] value jacobian runs:

    - "gather": delta_row = sum_p w[p] * Jv[idx[p]] in row chunks — the
      [chunk, L, N] gathered temporary is the memory cost.
    - "matmul": scatter the (idx, w) slots of each chunk into a dense
      [chunk, C*U + T] coefficient matrix and take ONE
      [chunk, M] @ [M, N] matmul — less memory traffic for long-pad
      buckets, and the work runs as a matrix product instead of
      gathers. Same result up to summation order.

    ``dtype`` (e.g. jnp.float32) downcasts Jv and the contraction:
    the curve graph and jacobian stay f64 (calibration precision), only
    the per-trade accumulation drops — risk ladders are reporting
    artifacts, not calibration inputs. The float32 matmul runs at
    ``Precision.HIGHEST`` (no TF32), and ``chip_smoke.py`` holds it
    within 1e-6 of float64, relative to the largest ladder entry."""
    basket = mb.basket
    grids = basket.grids
    params = jax.device_put(basket.params)
    cols = jax.device_put(mb.cols)
    clamp = jax.device_put(mb.clamp) if mb.clamp is not None else None
    _, clamp, cols = _device_expand(None, clamp, mb.tile, cols=cols)
    agg = jax.device_put(mb.aggregate)
    n_trades = mb.n_trades
    if method not in ("gather", "matmul"):
        raise ValueError(f"unknown per-trade delta method: {method!r}")

    @jax.jit
    def _fn(qvec, P, cbs, cl, ag):
        dfs_flat = grids(qvec, P)
        J = jax.jacfwd(lambda q: grids(q, P))(qvec)      # [C*U, N]
        N = J.shape[1]

        # d tripval / d quotes, closed form from the gathered J rows:
        # tripval = (a/b - 1) c  with a=df_s, b=df_e, c=df_p
        a = dfs_flat[ag.trip_s][:, None]
        b_ = dfs_flat[ag.trip_e][:, None]
        c_ = dfs_flat[ag.trip_p][:, None]
        J_trip = (J[ag.trip_s] * (c_ / b_)
                  - J[ag.trip_e] * (a * c_ / (b_ * b_))
                  + J[ag.trip_p] * (a / b_ - 1.0))
        Jv = jnp.concatenate([J, J_trip])                # [C*U + T, N]
        if dtype is not None:
            Jv = Jv.astype(dtype)
        out = jnp.zeros((n_trades, N), Jv.dtype)
        M = Jv.shape[0]

        for cb in cbs:
            R = cb.col_idx.shape[0]
            pad = (-R) % chunk

            def padded(x, fill=0):
                return jnp.concatenate(
                    [x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)]) \
                    if pad else x

            stacked = [padded(cb.col_idx), padded(cb.w)]
            stacked = [x.reshape((-1, chunk) + x.shape[1:])
                       for x in stacked]

            if method == "matmul":
                rows = jnp.broadcast_to(
                    jnp.arange(chunk, dtype=jnp.int32)[:, None],
                    stacked[0].shape[1:])

                def chunk_delta(args):
                    ci, wi = args
                    # dead slots carry w == 0.0: scattering them onto
                    # column 0 adds exact zeros
                    W = jnp.zeros((chunk, M), Jv.dtype)
                    W = W.at[rows, ci].add(wi.astype(Jv.dtype))
                    # HIGHEST: a float32 product would otherwise run in
                    # TF32 on the GPU (~1e-3 relative)
                    return jnp.matmul(W, Jv,
                                      precision=lax.Precision.HIGHEST)
            else:
                def chunk_delta(args):
                    ci, wi = args
                    # multiply+sum, not einsum: "bp,bpn->bn" lowers to a
                    # batch of [1, P] @ [P, N] micro-matmuls (the same
                    # lowering that cost the PV sweep 7x)
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
            fwd = jnp.where(cl.ia > 0.0, (df_s / df_e - 1.0) / ia_safe,
                            0.0)
            pre = fwd + cl.spread
            rate = jnp.clip(pre, cl.floor, cl.cap)
            inside = ((pre > cl.floor) & (pre < cl.cap)).astype(df_s.dtype)
            cp = cl.w * rate                                  # d/d df_p
            cs = cl.w * df_p * inside / (ia_safe * df_e)
            ce = -cl.w * df_p * inside * df_s / (ia_safe * df_e * df_e)
            d = (cp[:, None] * J[cl.p_idx] + cs[:, None] * J[cl.s_idx]
                 + ce[:, None] * J[cl.e_idx])
            out = out.at[cl.slot_trade].add(d.astype(out.dtype))
        return out

    def fn(qvec):
        return _fn(jnp.asarray(qvec), params, cols, clamp, agg)

    return fn
