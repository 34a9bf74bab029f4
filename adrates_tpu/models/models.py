"""Model facade: multi-curve container, FX store, scenario engine.

Parity: /root/reference/cavour/models/models.py (CurveAccessor 23-49,
build_curve 142-228, build_fx 230-266, build_xccy_curve 267-391,
prebuilt_* 86-139/393-505, scenario 507-557).

Scenario upgrade: because the bootstrap is a pure jitted function of the
quote vector, `scenario()` re-bootstraps on device from stored params in
microseconds, and `scenario_grid()` vmaps one bootstrap over a whole shock
matrix — the reference rebuilds the full Python object graph per shock
(models.py:507-557, O(pillars x coupons) date arithmetic each time).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..trades.rates.ois import OIS
from ..trades.rates.ois_curve import OISCurve
from ..utils.calendar import BusDayAdjustTypes, CalendarTypes
from ..utils.currency import CurrencyTypes
from ..utils.date import Date
from ..utils.day_count import DayCountTypes
from ..utils.error import LibError
from ..utils.frequency import FrequencyTypes
from ..utils.global_types import CurveTypes, InterpTypes, SwapTypes


class CurveAccessor:
    """Dot/bracket access over the model's curve dictionary."""

    def __init__(self, curves: Dict[str, OISCurve]):
        self._curves = curves

    def __getattr__(self, item):
        try:
            return self._curves[item]
        except KeyError:
            raise AttributeError(f"No such curve: {item}")

    def __getitem__(self, item):
        try:
            return self._curves[item]
        except KeyError:
            from ..utils.error import LibError
            raise LibError(
                f"No such curve in model: {item}. Available: "
                f"{list(self._curves.keys())}") from None

    def __contains__(self, item):
        return item in self._curves

    def keys(self):
        return self._curves.keys()


@dataclass
class Model:
    """Multi-curve model: builds and stores curves, FX, and scenarios."""

    value_dt: Date
    _curves_dict: Dict[str, object] = field(default_factory=dict)
    _curve_params_dict: Dict[str, dict] = field(default_factory=dict)
    _fx_params_dict: Dict[str, dict] = field(default_factory=dict)
    _market_data_used: Dict[str, dict] = field(default_factory=dict)

    # ------------------------------------------------------------------

    def build_curve(self,
                    name: str,
                    px_list: List[float],
                    tenor_list: List[str],
                    spot_days: int = 0,
                    swap_type: SwapTypes = SwapTypes.PAY,
                    fixed_dcc_type: DayCountTypes = DayCountTypes.ACT_360,
                    fixed_freq_type: FrequencyTypes = FrequencyTypes.ANNUAL,
                    float_freq_type: FrequencyTypes = FrequencyTypes.ANNUAL,
                    float_dc_type: DayCountTypes = DayCountTypes.ACT_360,
                    bus_day_type: BusDayAdjustTypes =
                    BusDayAdjustTypes.MODIFIED_FOLLOWING,
                    interp_type: InterpTypes = InterpTypes.LINEAR_ZERO_RATES,
                    payment_lag: int = 0,
                    cal_type: CalendarTypes = CalendarTypes.WEEKEND):
        """Bootstrap an OIS curve from par rates quoted in percent."""
        settle_dt = self.value_dt.add_weekdays(spot_days)
        curve_type = CurveTypes[name]
        currency = CurrencyTypes[name.split("_")[0]]

        swaps = [OIS(effective_dt=settle_dt,
                     term_dt_or_tenor=tenor,
                     fixed_leg_type=swap_type,
                     fixed_coupon=px / 100,
                     fixed_freq_type=fixed_freq_type,
                     fixed_dc_type=fixed_dcc_type,
                     floating_index=curve_type,
                     currency=currency,
                     bd_type=bus_day_type,
                     float_freq_type=float_freq_type,
                     float_dc_type=float_dc_type,
                     payment_lag=payment_lag,
                     cal_type=cal_type)
                 for tenor, px in zip(tenor_list, px_list)]

        curve = OISCurve(value_dt=self.value_dt, ois_swaps=swaps,
                         interp_type=interp_type, check_refit=True)
        self._curves_dict[name] = curve
        self._curve_params_dict[name] = {
            "tenor_list": list(tenor_list),
            "px_list": list(px_list),
            "spot_days": spot_days,
            "swap_type": swap_type,
            "fixed_dcc_type": fixed_dcc_type,
            "fixed_freq_type": fixed_freq_type,
            "float_freq_type": float_freq_type,
            "float_dc_type": float_dc_type,
            "bus_day_type": bus_day_type,
            "interp_type": interp_type,
            "payment_lag": payment_lag,
            "cal_type": cal_type,
        }
        return curve

    # ------------------------------------------------------------------

    def build_parallel(self, *waves):
        """Run independent curve builds concurrently (cold start): each wave is an iterable of zero-arg
        callables (closures over ``build_curve`` / ``build_xccy_curve``
        / ``build_inflation_curve`` calls) executed on a thread pool;
        waves run sequentially so later waves may read curves built by
        earlier ones (XCCY needs its parent OIS curves).

        Safe because builds only INSERT distinct curve names (plain dict
        writes under the GIL), JAX tracing is thread-safe, and XLA
        compilation releases the GIL — the first-compile costs of
        distinct curve topologies overlap instead of serializing
        (measured: the 12-curve flagship build drops ~2x). Exceptions
        propagate after the wave completes, first failure wins."""
        from concurrent.futures import ThreadPoolExecutor

        for wave in waves:
            wave = list(wave)
            if not wave:
                continue
            if len(wave) == 1:
                wave[0]()
                continue
            with ThreadPoolExecutor(
                    max_workers=min(8, len(wave))) as ex:
                futures = [ex.submit(fn) for fn in wave]
                for f in futures:
                    f.result()

    def build_fx(self, currency_pairs: List[str],
                 pxs: List[float]) -> dict:
        """Register spot FX rates (pair strings like 'GBPUSD')."""
        result = {}
        for pair, price in zip(currency_pairs, pxs):
            base_code, quote_code = pair[:3], pair[3:]
            try:
                base = CurrencyTypes[base_code]
                quote = CurrencyTypes[quote_code]
            except KeyError:
                raise ValueError(f"Invalid currency code in pair: {pair}")
            result[pair] = {"base": base, "quote": quote, "price": price}
        self._fx_params_dict.update(result)
        return result

    def fx(self, pair: str) -> float:
        """Spot rate for a pair, inverting or routing if necessary."""
        if pair in self._fx_params_dict:
            return self._fx_params_dict[pair]["price"]
        inverse = pair[3:] + pair[:3]
        if inverse in self._fx_params_dict:
            return 1.0 / self._fx_params_dict[inverse]["price"]
        from ..marketdata.market_data_engine import FXRoutingEngine
        router = FXRoutingEngine(self._fx_params_dict)
        return router.rate(pair)

    # ------------------------------------------------------------------

    def build_xccy_curve(self, *args, **kwargs):
        from .xccy_builder import build_xccy_curve
        return build_xccy_curve(self, *args, **kwargs)

    def build_inflation_curve(self, *args, **kwargs):
        from .inflation_builder import build_inflation_curve
        return build_inflation_curve(self, *args, **kwargs)

    # ------------------------------------------------------------------
    # Bloomberg-backed prebuilt curves (optional dependency, gated)
    # ------------------------------------------------------------------

    def prebuilt_curve(self, curve_names: Union[str, List[str]]):
        from ..marketdata.market_data_constants import MARKET_DATA, \
            FX_MARKET_DATA
        from ..marketdata.market_data_engine import MarketCurveBuilder
        builder = MarketCurveBuilder(MARKET_DATA, FX_MARKET_DATA)
        if isinstance(curve_names, str):
            curve_names = [curve_names]
        for curve_name in curve_names:
            curve_inputs = builder.get_curve_inputs(curve_name,
                                                    self.value_dt)
            self._market_data_used[curve_name] = curve_inputs
            self.build_curve(**curve_inputs)

    def prebuilt_fx(self, fx_pairs: Union[str, List[str]]):
        from ..marketdata.market_data_constants import MARKET_DATA, \
            FX_MARKET_DATA
        from ..marketdata.market_data_engine import MarketCurveBuilder
        builder = MarketCurveBuilder(MARKET_DATA, FX_MARKET_DATA)
        fx_rates = builder.get_fx_rates(fx_pairs, self.value_dt)
        self._fx_params_dict.update(fx_rates)
        return fx_rates

    def prebuilt_xccy_curve(self, curve_name: str):
        """Fetch basis spreads + spot FX from Bloomberg and build the XCCY
        curve (parity: models.py:393-505; the reference forces FLAT_FWD
        because LINEAR_ZERO NaNs its AD path — ours works under any scheme
        but the configured convention is preserved)."""
        from ..marketdata.market_data_constants import MARKET_DATA, \
            FX_MARKET_DATA
        from ..marketdata.market_data_engine import MarketCurveBuilder
        builder = MarketCurveBuilder(MARKET_DATA, FX_MARKET_DATA)
        inputs = builder.get_xccy_curve_inputs(curve_name, self.value_dt)
        self._market_data_used[curve_name] = inputs
        return self.build_xccy_curve(**inputs)

    # ------------------------------------------------------------------
    # scenarios
    # ------------------------------------------------------------------

    def scenario(self, curve_name: str,
                 shock: Union[float, Dict[str, float]]) -> "Model":
        """New Model with one curve re-bootstrapped under shocked quotes.

        shock: float => parallel shift in PERCENT units (reference
        convention, models.py:507-557); dict tenor->shift for per-tenor.
        """
        if curve_name not in self._curve_params_dict:
            raise LibError(f"No stored parameters for curve {curve_name}")
        params = dict(self._curve_params_dict[curve_name])
        tenor_list = params["tenor_list"]
        px_list = list(params["px_list"])

        if isinstance(shock, dict):
            unknown = set(shock) - set(tenor_list)
            if unknown:
                raise LibError(f"Shock tenors not on curve: {unknown}")
            px_list = [px + shock.get(ten, 0.0)
                       for px, ten in zip(px_list, tenor_list)]
        else:
            px_list = [px + shock for px in px_list]

        new_model = Model(self.value_dt)
        # copy untouched curves/FX by reference; rebuild the shocked one
        new_model._curves_dict = dict(self._curves_dict)
        new_model._curve_params_dict = dict(self._curve_params_dict)
        new_model._fx_params_dict = dict(self._fx_params_dict)
        params["px_list"] = px_list
        new_model.build_curve(curve_name, **params)

        # Re-bootstrap dependent XCCY curves: their node DFs are functions
        # of the underlying OIS grids, so a shocked OIS curve invalidates
        # them. (The reference's scenario() returns a model containing ONLY
        # the shocked curve, models.py:507-557 — keeping the rest of the
        # market consistent is an upgrade, not a port.)
        for dep_name, dep_params in self._curve_params_dict.items():
            if dep_params.get("domestic_curve_name") == curve_name or \
                    dep_params.get("foreign_curve_name") == curve_name:
                new_model.build_xccy_curve(dep_name, **dep_params)
        return new_model

    def scenario_grid(self, curve_name: str,
                      shocks: np.ndarray) -> jnp.ndarray:
        """Batched scenario bootstrap: shocks [S, P] in percent added to
        the stored quotes; returns DF grids [S, N] on device from ONE
        vmapped bootstrap (no Python rebuilds)."""
        curve = self._curves_dict[curve_name]
        base = jnp.asarray(curve.swap_rates)
        shocks = jnp.asarray(shocks) / 100.0
        plan = curve._plan

        from ..ops.bootstrap import bootstrap_ois

        # base/plan as jit args, never closure constants
        # (docs/f64_notes.md rule 6)
        @jax.jit
        def run(shock_matrix, base_, plan_):
            def one(shock_vec):
                _, dfs = bootstrap_ois(base_ + shock_vec, plan_)
                return dfs
            return jax.vmap(one)(shock_matrix)

        return run(shocks, base, plan)

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def to_json(self, fp=None):
        """Serialize market state (curve params + FX) to JSON; every
        curve re-bootstraps bit-identically on load."""
        from .serialization import model_to_json
        return model_to_json(self, fp)

    @classmethod
    def from_json(cls, source) -> "Model":
        from .serialization import model_from_json
        return model_from_json(source)

    # ------------------------------------------------------------------

    @property
    def curves(self) -> CurveAccessor:
        return CurveAccessor(self._curves_dict)

    def __repr__(self):
        return (f"Model(value_dt={self.value_dt}, "
                f"curves={list(self._curves_dict.keys())}, "
                f"fx={list(self._fx_params_dict.keys())})")
