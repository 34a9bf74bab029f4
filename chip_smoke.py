"""Chip smoke test: the flagship book-risk path once on an NVIDIA GPU, checked.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py              # one card, every phase below
    python chip_smoke.py --chips 4    # only the sharded path, on 4 cards

Phases, in one process (a failed check raises, and the script exits
non-zero without printing a result line):

- device: requires JAX's GPU backend; prints the device kind and count and
  the card's name and power limit from ``nvidia-smi``;
- f64 gates: ``adrates_tpu.f64_gates`` on the card;
- curves: the 12 flagship curves built on the GPU tier and on the host
  tier (``ADRATES_BUILD_DEVICE``); every refit holds 1e-10 (a build
  raises otherwise) and the pillar DFs of the two builds agree;
- quickstart: the README quickstart on both request tiers;
- flagship: the ~100k-trade book x 100 scenarios through
  ``warmup_multibook(staged=True)``, with each region's compile seconds
  and memory analysis, one warm call, and the peak device memory;
- reference: (a) staged vs the monolith on the GPU and vs the staged fn
  on the host CPU, base book, 4 scenarios; (b) tile linearity of the
  total PV; (c) the book delta at the base scenario vs the column sum of
  the per-trade ladders, and the float32 ladders vs float64; (d) the
  full-book per-trade gamma blocks are finite.

``--chips 4`` runs only ``make_sharded_multibook_fn``,
``make_sharded_per_trade_delta_fn`` and
``make_sharded_per_trade_gamma_blocks_fn`` over a 1-D mesh of four
cards, each compared with the single-card result.

The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

N_SCENARIOS = 100
SMALL_SCENARIOS = 4
QUICKSTART_NOTIONAL = 10_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(a, b) -> float:
    """max|a - b| / max|b|: the error relative to the largest magnitude
    (GPU reductions sum in another order, so no bitwise comparison)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        raise AssertionError(f"shape {a.shape} != {b.shape}")
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def check(name: str, err: float, limit: float) -> None:
    log(f"  {name}: {err:.3e} (limit {limit:.0e})")
    if not err <= limit:
        raise AssertionError(f"{name}: {err:.3e} exceeds {limit:.0e}")


@contextlib.contextmanager
def env(**values):
    """Temporarily set environment variables (the device tiers of
    ``adrates_tpu.utils.device_policy`` read theirs at call time)."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def card_info() -> list:
    """One "name, power limit" line per card, from nvidia-smi (a child
    process that does not touch JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()


# ---------------------------------------------------------------------------
# comparisons shared with tests/test_chip_smoke.py
# ---------------------------------------------------------------------------


def staged_vs_references(mb, q0, shocks, cpu) -> dict:
    """(a) The staged fn on the default device against the monolith
    ``make_multibook_fn`` on the default device and against the staged fn
    on ``cpu``. Returns {"<ref>.<key>": rel_err}."""
    import jax

    from adrates_tpu.parallel import (make_multibook_fn,
                                      make_staged_multibook_fn)

    staged = make_staged_multibook_fn(mb)(q0, shocks)
    mono = make_multibook_fn(mb)(q0, shocks)
    with jax.default_device(cpu):
        staged_cpu = make_staged_multibook_fn(mb)(q0, shocks)
        on = {d.platform for d in staged_cpu["delta"].devices()}
    if on != {cpu.platform}:
        raise AssertionError(f"host reference ran on {on}")
    errs = {}
    for ref_name, ref in (("monolith", mono), ("staged_cpu", staged_cpu)):
        for k in ("pvs", "delta", "gamma"):
            errs[f"{ref_name}.{k}"] = rel_err(staged[k], ref[k])
    return errs


def base_book_totals(mb_base, q0, shocks) -> np.ndarray:
    """[S] total PV of the untiled book per scenario through the
    aggregate-weight path (``aggregate_total``), not the per-trade sweep."""
    import jax
    import jax.numpy as jnp

    from adrates_tpu.parallel import aggregate_total
    from adrates_tpu.parallel.multibook import _agg_clamp

    grids = mb_base.basket.grids
    clamp_agg = _agg_clamp(mb_base.clamp, None)

    @jax.jit
    def totals(q, P, ag, cl, sh):
        return jax.vmap(
            lambda s: aggregate_total(grids(q + s, P), ag, cl))(sh)

    return np.asarray(totals(jnp.asarray(q0), mb_base.basket.params,
                             mb_base.aggregate, clamp_agg,
                             jnp.asarray(shocks)))


def tile_linearity_error(pvs, base_totals, scale) -> float:
    """(b) Every scenario's tiled-book total equals sum_k scale_k times
    the base-book total."""
    return rel_err(np.asarray(pvs).sum(axis=1),
                   np.sum(scale) * np.asarray(base_totals))


def ladder_sum_error(ladders, delta0) -> float:
    """(c) The book delta at the base scenario equals the column sum of
    the per-trade ladders."""
    return rel_err(np.asarray(ladders).sum(axis=0), delta0)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def require_gpu(n_devices: int):
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: needs JAX's GPU backend, found "
                         f"{backend!r}")
    devices = jax.devices()
    if len(devices) < n_devices:
        raise SystemExit(f"chip_smoke: needs {n_devices} GPUs, found "
                         f"{len(devices)}")
    d = devices[0]
    log(f"device: platform={d.platform} kind={d.device_kind} "
        f"count={len(devices)}")
    for line in card_info():
        log(f"card: {line}")
    return devices


def phase_f64_gates():
    from adrates_tpu.f64_gates import GATES

    log("f64 gates on the card:")
    with env(ADRATES_BUILD_DEVICE="default"):
        for name, gate, bound in GATES:
            check(name, gate(), bound)


def _tier_device(tier):
    import jax.numpy as jnp

    with tier():
        return str(next(iter(jnp.zeros(2).devices())))


def phase_curves():
    """Returns the host-tier model (the default routing)."""
    from adrates_tpu.utils.device_policy import on_build_device

    from benchmarks.flagship_book import build_model

    models = {}
    for mode in ("default", "host"):
        with env(ADRATES_BUILD_DEVICE=mode):
            t0 = time.perf_counter()
            models[mode] = build_model()
            secs = time.perf_counter() - t0
            dev = _tier_device(on_build_device)
        log(f"curves, {mode} tier on {dev}: "
            f"{len(list(models[mode].curves.keys()))} curves built in "
            f"{secs:.1f} s, every refit within 1e-10")
    gpu, host = models["default"], models["host"]
    err = max(float(np.max(np.abs(np.asarray(gpu.curves[n]._dfs)
                                  - np.asarray(host.curves[n]._dfs))))
              for n in host.curves.keys())
    check("pillar DFs, GPU tier vs host tier (abs)", err, 1e-12)
    return host


def quickstart():
    """The README quickstart: (PV, delta ladder, gamma matrix)."""
    from adrates_tpu.models import Model
    from adrates_tpu.trades.rates import OIS
    from adrates_tpu.utils import (CurrencyTypes, CurveTypes, Date,
                                   DayCountTypes, FrequencyTypes,
                                   RequestTypes, SwapTypes)

    model = Model(Date(1, 1, 2024))
    model.build_curve(
        "GBP_OIS_SONIA",
        px_list=[5.19, 4.71, 4.35, 3.93, 3.87, 3.71],
        tenor_list=["1M", "1Y", "2Y", "5Y", "10Y", "30Y"],
        fixed_dcc_type=DayCountTypes.ACT_365F,
        float_dc_type=DayCountTypes.ACT_365F)
    swap = OIS(Date(1, 1, 2024), "10Y", SwapTypes.RECEIVE, 0.0387,
               FrequencyTypes.ANNUAL, DayCountTypes.ACT_365F,
               CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
               notional=QUICKSTART_NOTIONAL,
               float_dc_type=DayCountTypes.ACT_365F)
    res = swap.position(model).compute(
        [RequestTypes.VALUE, RequestTypes.DELTA, RequestTypes.GAMMA])
    return (res.value.amount, np.asarray(res.risk.risk_ladder),
            np.asarray(res.gamma.risk_ladder))


def phase_quickstart():
    from adrates_tpu.utils.device_policy import on_request_device

    out = {}
    for mode in ("default", "host"):
        with env(ADRATES_BUILD_DEVICE=mode, ADRATES_REQUEST_DEVICE=mode):
            out[mode] = quickstart()
            dev = _tier_device(on_request_device)
        log(f"quickstart, {mode} tier on {dev}: PV {out[mode][0]:.6e}")
    # the swap is at par, so its PV is ~0: scale it by the notional, as
    # the refit gate does
    check("quickstart PV / notional, GPU tier vs host tier",
          abs(out["default"][0] - out["host"][0]) / QUICKSTART_NOTIONAL,
          1e-10)
    for i, name in ((1, "delta"), (2, "gamma")):
        check(f"quickstart {name}, GPU tier vs host tier (rel)",
              rel_err(out["default"][i], out["host"][i]), 1e-10)


def _memory_line(name, compiled) -> str:
    ma = compiled.memory_analysis()
    if ma is None:
        return f"  {name}: memory analysis not available"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    return f"  {name}: " + " ".join(
        f"{f.replace('_size_in_bytes', '')}={getattr(ma, f, None)}"
        for f in fields)


def phase_flagship(model, seed: int):
    """The book run; returns what the reference phase checks."""
    import jax

    from adrates_tpu.parallel import warmup_multibook

    from benchmarks.flagship_book import build_book, scenario_shocks

    t0 = time.perf_counter()
    mb_base, mb, scale = build_book(model, seed)
    N = mb.basket.n_quotes
    B = mb.n_trades
    log(f"flagship: {mb_base.n_trades} base trades tiled x{scale.shape[0]}"
        f" -> {B} trades, {N} quotes, n_grid {mb.basket.n_grid} "
        f"(trade compile {time.perf_counter() - t0:.1f} s)")
    shocks = scenario_shocks(N, N_SCENARIOS, seed)
    q0 = np.asarray(mb.basket.quotes0)

    t0 = time.perf_counter()
    fn = warmup_multibook(mb, N_SCENARIOS, want_gamma=True, staged=True,
                          parallel=True)
    log(f"warmup_multibook(staged=True, S={N_SCENARIOS}): "
        f"{time.perf_counter() - t0:.1f} s incl. compile and first call "
        f"(chunk {fn.chunk})")
    log(f"region compile seconds: {json.dumps(fn.compile_seconds)}")
    log("region memory analysis (bytes):")
    for name in sorted(fn.programs):
        log(_memory_line(name, fn.programs[name]))

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(q0, shocks))
    log(f"warm call: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")

    out = {k: np.asarray(v) for k, v in out.items()}
    expect = {"pvs": (N_SCENARIOS, B), "delta": (N_SCENARIOS, N),
              "gamma": (N_SCENARIOS, N, N)}
    for k, shape in expect.items():
        if out[k].shape != shape or not np.isfinite(out[k]).all():
            raise AssertionError(f"{k}: shape {out[k].shape} (want "
                                 f"{shape}), finite "
                                 f"{np.isfinite(out[k]).all()}")
    log(f"  outputs finite with shapes "
        f"{ {k: v.shape for k, v in out.items()} }")
    g = out["gamma"]
    check("gamma symmetry (rel to max|gamma|)",
          rel_err(g, np.swapaxes(g, 1, 2)), 1e-10)
    return mb_base, mb, scale, q0, shocks, out


def phase_reference(mb_base, mb, scale, q0, shocks, out):
    import jax
    import jax.numpy as jnp

    from adrates_tpu.parallel import (make_per_trade_delta_fn,
                                      make_per_trade_gamma_blocks_fn)

    log("(b) tile linearity:")
    check("total PV vs sum_k scale_k x base total (rel)",
          tile_linearity_error(out["pvs"],
                               base_book_totals(mb_base, q0, shocks),
                               scale), 1e-11)

    log("(c) per-trade ladders:")
    t0 = time.perf_counter()
    ladders = np.asarray(jax.block_until_ready(
        make_per_trade_delta_fn(mb)(q0)))
    log(f"  ladders {ladders.shape} in {time.perf_counter() - t0:.1f} s "
        f"incl. compile")
    check("column sum vs book delta at the base scenario (rel)",
          ladder_sum_error(ladders, out["delta"][0]), 1e-10)
    l32 = make_per_trade_delta_fn(mb, dtype=jnp.float32,
                                  method="matmul")(q0)
    check("float32 matmul ladders vs float64 (rel)",
          rel_err(l32, ladders), 1e-6)

    log("(d) per-trade gamma blocks:")
    t0 = time.perf_counter()
    groups = make_per_trade_gamma_blocks_fn(mb)(q0)
    jax.block_until_ready([g.blocks for g in groups])
    n_blk = sum(int(g.trade_ids.shape[0]) for g in groups)
    if not all(np.isfinite(np.asarray(g.blocks)).all() for g in groups):
        raise AssertionError("per-trade gamma blocks are not finite")
    log(f"  {n_blk} trades in {len(groups)} signature groups, finite "
        f"({time.perf_counter() - t0:.1f} s incl. compile)")

    log(f"(a) base book, S={SMALL_SCENARIOS}: staged vs monolith (GPU) "
        f"and vs staged on the host CPU:")
    t0 = time.perf_counter()
    errs = staged_vs_references(mb_base, q0, shocks[:SMALL_SCENARIOS],
                                jax.devices("cpu")[0])
    for name, err in errs.items():
        check(name, err, 1e-9)
    log(f"  ({time.perf_counter() - t0:.1f} s incl. compiles)")


def phase_sharded(model, seed: int, n_devices: int):
    """Sharded book, ladders and gamma blocks over a 1-D mesh, each
    against the single-card result."""
    import jax
    from jax.sharding import Mesh

    from adrates_tpu.parallel import (make_per_trade_delta_fn,
                                      make_per_trade_gamma_blocks_fn,
                                      make_sharded_multibook_fn,
                                      make_sharded_per_trade_delta_fn,
                                      make_sharded_per_trade_gamma_blocks_fn,
                                      warmup_multibook)

    from benchmarks.flagship_book import build_book, scenario_shocks

    mesh = Mesh(np.array(jax.devices()[:n_devices]), ("book",))
    _, mb, _ = build_book(model, seed)
    shocks = scenario_shocks(mb.basket.n_quotes, N_SCENARIOS, seed)
    q0 = np.asarray(mb.basket.quotes0)
    log(f"sharded over {n_devices} cards: {mb.n_trades} trades, "
        f"S={N_SCENARIOS}")

    t0 = time.perf_counter()
    ref = warmup_multibook(mb, N_SCENARIOS, staged=True)(q0, shocks)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    log(f"  single card (staged): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out = make_sharded_multibook_fn(mb, mesh)(q0, shocks)
    out = {k: np.asarray(v) for k, v in out.items()}
    log(f"  sharded book: {time.perf_counter() - t0:.1f} s incl. compile")
    check("total PV, sharded vs single card (rel)",
          rel_err(out["total_pv"], ref["pvs"].sum(axis=1)), 1e-10)
    for k in ("delta", "gamma"):
        check(f"{k}, sharded vs single card (rel)",
              rel_err(out[k], ref[k]), 1e-10)

    t0 = time.perf_counter()
    sd = make_sharded_per_trade_delta_fn(mb, mesh)
    lad = np.asarray(sd(q0))[:sd.n_trades]
    log(f"  sharded ladders {lad.shape}: {time.perf_counter() - t0:.1f} s")
    check("per-trade ladders, sharded vs single card (rel)",
          rel_err(lad, make_per_trade_delta_fn(mb)(q0)), 1e-10)

    t0 = time.perf_counter()
    out_g = make_sharded_per_trade_gamma_blocks_fn(mb, mesh)(q0)
    ref_g = make_per_trade_gamma_blocks_fn(mb)(q0)
    log(f"  gamma blocks, sharded and single card: "
        f"{time.perf_counter() - t0:.1f} s")
    if len(out_g) != len(ref_g):
        raise AssertionError(f"{len(out_g)} groups vs {len(ref_g)}")
    check("per-trade gamma blocks, sharded vs single card (rel)",
          max(rel_err(o.blocks, r.blocks) for o, r in zip(out_g, ref_g)),
          1e-10)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded path over four cards")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    devices = require_gpu(args.chips)

    import adrates_tpu

    cache = adrates_tpu.configure_cache()
    log(f"compile cache: {cache} ({len(os.listdir(cache))} entries at "
        f"start)")

    if args.chips == 4:
        from benchmarks.flagship_book import build_model
        phase_sharded(build_model(), args.seed, args.chips)
    else:
        phase_f64_gates()
        model = phase_curves()
        phase_quickstart()
        phase_reference(*phase_flagship(model, args.seed))
    log(f"total {time.perf_counter() - t_start:.1f} s")

    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
