"""Benchmark: multi-currency book PV + delta + gamma throughput, one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}}

Headline metric (BASELINE.md flagship config, incl. config 4's inflation
book; builders in benchmarks/flagship_book.py): bootstrap 12 curves across
7 currencies (7 OIS + 3 XCCY + 2 inflation), revalue a 100k-trade MIXED
book (OIS + XCCY basis swaps + FRNs incl. capped + bonds + ZCIS + YoY
inflation swaps, mixed day counts/frequencies/pay lags/directions,
seasoned and forward-starting trades) x 100 scenarios with the full
cross-curve delta ladder and NxN gamma (N = every quote on every curve:
rates + basis spreads + breakevens) per scenario.

Baseline: the reference prices ONE swap's PV+delta+gamma in ~40 ms on CPU
(README.md of the reference), i.e. ~25 trade-scenarios/sec.

Secondary numbers (stderr): cold curve build, warm bootstrap, warm
single-request latency, staged warmup, book pass, per-trade ladders and
gammas. The run needs JAX's GPU backend; a failed phase fails the run.
"""

import json
import os
import sys
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py needs JAX's GPU backend, found "
                         f"{jax.default_backend()!r}")

    import adrates_tpu

    cache_dir = adrates_tpu.configure_cache()
    n_pre = len(os.listdir(cache_dir))
    log(f"persistent compile cache: {cache_dir} "
        f"({n_pre} entries at start — cold numbers are cold iff 0)")

    import jax.numpy as jnp

    from adrates_tpu.utils import (CurrencyTypes, CurveTypes,
                                   DayCountTypes, FrequencyTypes,
                                   RequestTypes, SwapTypes,
                                   BusDayAdjustTypes)
    from adrates_tpu.parallel import (make_per_trade_delta_fn,
                                      make_per_trade_gamma_blocks_fn,
                                      make_per_trade_gamma_fn,
                                      warmup_multibook)
    from adrates_tpu.trades.rates import OIS

    from benchmarks.flagship_book import build_book, build_model
    from chip_smoke import card_info

    devices = jax.devices()
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices)}
    cards = card_info()
    log(f"device: {device}; cards: {cards}")
    seed = 7
    rng = np.random.default_rng([seed, 2])
    phases = {}

    # --- config 1: build 12 curves (7 OIS + 3 XCCY + 2 inflation) -------
    t0 = time.perf_counter()
    model = build_model()
    phases["curve_build_cold_ms"] = round(
        (time.perf_counter() - t0) * 1e3, 1)
    log(f"build 12 curves / 7 currencies (cold, incl. compile+refit): "
        f"{phases['curve_build_cold_ms']:.0f} ms")

    curve = model.curves.GBP_OIS_SONIA
    from adrates_tpu.ops.bootstrap import bootstrap_ois
    reboot = jax.jit(bootstrap_ois)
    plan_dev = jax.device_put(curve._plan)
    r_jnp = jnp.asarray(curve.swap_rates)
    jax.block_until_ready(reboot(r_jnp, plan_dev))
    t0 = time.perf_counter()
    for _ in range(100):
        out = reboot(r_jnp, plan_dev)
    jax.block_until_ready(out)
    phases["bootstrap_warm_ms"] = round(
        (time.perf_counter() - t0) / 100 * 1e3, 3)
    log(f"bootstrap 32-pillar (warm, jitted): "
        f"{phases['bootstrap_warm_ms']:.3f} ms (reference ~50 ms)")

    # --- config 2: single 10Y swap PV+delta+gamma (warm latency) --------
    swap = OIS(model.value_dt, "10Y", SwapTypes.RECEIVE, 0.0387,
               FrequencyTypes.ANNUAL, DayCountTypes.ACT_365F,
               CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
               notional=10_000_000, float_dc_type=DayCountTypes.ACT_365F,
               bd_type=BusDayAdjustTypes.MODIFIED_FOLLOWING)
    pos = swap.position(model)
    reqs = [RequestTypes.VALUE, RequestTypes.DELTA, RequestTypes.GAMMA]
    pos.compute(reqs)  # compile
    t0 = time.perf_counter()
    n_rep = 20
    for _ in range(n_rep):
        pos.compute(reqs)
    phases["single_swap_warm_ms"] = round(
        (time.perf_counter() - t0) / n_rep * 1e3, 2)
    log(f"10Y swap PV+delta+gamma (warm): "
        f"{phases['single_swap_warm_ms']:.2f} ms "
        f"(reference ~40 ms delta+gamma)")

    # --- config 3: 100k mixed multi-currency book x 100 scenarios -------
    t0 = time.perf_counter()
    mb_base, mb, scale = build_book(model, seed)
    n_base = mb_base.n_trades
    n_copies = scale.shape[0]
    n_total = mb.n_trades
    N = mb.basket.n_quotes
    phases["trade_compile_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
    log(f"compile {n_base} base trades -> tile to {n_total} "
        f"({phases['trade_compile_ms']:.0f} ms, "
        f"unique times {mb.unique_times.shape[0]}, quotes {N}, "
        f"bucket pads {[b.fix_idx.shape[1] for b in mb.buckets]}, "
        f"clamp slots "
        f"{0 if mb.clamp is None else mb.clamp.w.shape[0]})")

    n_scen = 100
    shocks = jnp.asarray(rng.normal(0.0, 1e-3, (n_scen, N)))
    q0 = jnp.asarray(mb.basket.quotes0)

    t0 = time.perf_counter()
    fn = warmup_multibook(mb, n_scen, want_gamma=True, staged=True,
                          parallel=True)
    phases["warmup_staged_parallel_ms"] = round(
        (time.perf_counter() - t0) * 1e3, 1)
    phases["staged_region_compile_s"] = fn.compile_seconds
    log(f"warmup_multibook (compile+first run, staged, S={n_scen}): "
        f"{phases['warmup_staged_parallel_ms']:.0f} ms; region "
        f"compiles: {fn.compile_seconds}")
    t0 = time.perf_counter()
    jax.block_until_ready(fn(q0, shocks))
    book_s = time.perf_counter() - t0

    trades_per_sec = n_total * n_scen / book_s
    phases["book_warm_ms"] = round(book_s * 1e3, 1)
    label = f"PV + {N}-pt delta + {N}x{N} gamma"
    log(f"100k mixed multi-ccy book x {n_scen} scenarios ({label}): "
        f"{book_s * 1e3:.0f} ms -> {trades_per_sec:,.0f} "
        f"trade-scenarios/sec")

    # --- config 4: per-trade delta ladders (single scenario) ------------
    per_trade = make_per_trade_delta_fn(mb, chunk=4096)
    jax.block_until_ready(per_trade(q0))
    t0 = time.perf_counter()
    jax.block_until_ready(per_trade(q0))
    phases["per_trade_ladders_ms"] = round(
        (time.perf_counter() - t0) * 1e3, 1)
    log(f"per-trade delta ladders [{n_total} x {N}]: "
        f"{phases['per_trade_ladders_ms']:.0f} ms")

    # --- per-trade gamma matrices (selected trades, single scenario) ----
    sel = rng.choice(n_total, 256, replace=False)
    pt_gamma = make_per_trade_gamma_fn(mb, sel)
    jax.block_until_ready(pt_gamma(q0))
    t0 = time.perf_counter()
    jax.block_until_ready(pt_gamma(q0))
    phases["per_trade_gamma_256_ms"] = round(
        (time.perf_counter() - t0) * 1e3, 1)
    log(f"per-trade gamma matrices [256 x {N} x {N}]: "
        f"{phases['per_trade_gamma_256_ms']:.0f} ms")

    # --- per-trade gamma BLOCKS, whole book ------------------------------
    t0 = time.perf_counter()
    blocks_fn = make_per_trade_gamma_blocks_fn(mb)
    # builder HOST cost (python slot-harvest loops) at this book diversity
    phases["per_trade_gamma_blocks_build_host_ms"] = round(
        (time.perf_counter() - t0) * 1e3, 1)
    log(f"gamma-blocks builder host time: "
        f"{phases['per_trade_gamma_blocks_build_host_ms']:.0f} ms")
    jax.block_until_ready([g.blocks for g in blocks_fn(q0)])
    t0 = time.perf_counter()
    groups = blocks_fn(q0)
    jax.block_until_ready([g.blocks for g in groups])
    phases["per_trade_gamma_blocks_full_ms"] = round(
        (time.perf_counter() - t0) * 1e3, 1)
    n_blk = sum(int(g.trade_ids.shape[0]) for g in groups)
    k_max = max(int(g.qidx.shape[0]) for g in groups)
    log(f"per-trade gamma blocks, FULL book [{n_blk} trades, "
        f"k<= {k_max}]: {phases['per_trade_gamma_blocks_full_ms']:.0f}"
        f" ms across {len(groups)} signature groups")

    phases["n_trades"] = n_total
    phases["n_base_topologies"] = n_base
    phases["n_scenarios"] = n_scen
    phases["n_quotes"] = N
    phases["cache_entries_at_start"] = n_pre
    # config ids, one per BASELINE.md row, bumped ONLY when the measured
    # workload changes shape. flagship_v5: 184 quotes, 12 curves, every
    # product family, ~1,004 distinct base topologies tiled to 100k.
    phases["configs"] = {
        "curve_build_cold_ms": "curves12_v1",
        "bootstrap_warm_ms": "bootstrap32_v1",
        "single_swap_warm_ms": "quickstart10y_v1",
        "book_warm_ms": "flagship_v5",
        "per_trade_ladders_ms": "flagship_v5",
        "per_trade_gamma_256_ms": "flagship_v5",
        "per_trade_gamma_blocks_full_ms": "flagship_v5",
    }
    log(f"phases: {json.dumps(phases)}")

    baseline_trades_per_sec = 25.0
    result = {
        "metric": "book_pv_delta_gamma_trades_per_sec",
        "value": round(trades_per_sec, 1),
        "unit": f"trade-scenarios/sec (100k mixed multi-ccy+inflation "
                f"book, {n_base} distinct base topologies tiled x"
                f"{n_copies}, incl. collateralized, x {n_scen} "
                f"scenarios, {label})",
        "config": "flagship_v5",
        "vs_baseline": round(trades_per_sec / baseline_trades_per_sec, 1),
        "device": device,
        "cards": cards,
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
