"""chip_smoke.py's comparisons on the CPU, at the tiny book of
multibook_cases: (a) staged == monolith == staged on the host device,
(b) tile linearity of the total PV, (c) the book delta equals the column
sum of the per-trade ladders, the float32 ladders stay within 1e-6 of
float64 — and the script itself refuses a backend without a GPU.

This is also the fast (not slow-marked) parity test of the book-risk
hot path: staged, monolith and per-trade agree on the CPU.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from adrates_tpu.parallel import (compile_multibook,
                                  make_per_trade_delta_fn,
                                  make_staged_multibook_fn, tile_multibook)
from adrates_tpu.utils import CurrencyTypes

from multibook_cases import build_model, trades_for

S = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def books():
    model = build_model()
    mb_base = compile_multibook(trades_for(model), model,
                                base_currency=CurrencyTypes.USD,
                                n_buckets=2)
    scale = np.array([1.0, 2.5, 0.5])
    mb = tile_multibook(mb_base, scale.shape[0], notional_scale=scale)
    rng = np.random.default_rng(0)
    shocks = rng.normal(0.0, 1e-3, (S, mb.basket.n_quotes))
    shocks[0] = 0.0
    q0 = np.asarray(mb.basket.quotes0)
    return mb_base, mb, scale, q0, shocks


@pytest.fixture(scope="module")
def tiled_out(books):
    _, mb, _, q0, shocks = books
    out = make_staged_multibook_fn(mb)(q0, shocks)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def ladders(books):
    _, mb, _, q0, _ = books
    return np.asarray(make_per_trade_delta_fn(mb)(q0))


def test_staged_matches_monolith_and_host(books):
    mb_base, _, _, q0, shocks = books
    errs = chip_smoke.staged_vs_references(mb_base, q0, shocks,
                                           jax.devices("cpu")[0])
    assert set(errs) == {f"{r}.{k}" for r in ("monolith", "staged_cpu")
                         for k in ("pvs", "delta", "gamma")}
    assert max(errs.values()) < 1e-9, errs


def test_tile_linearity(books, tiled_out):
    mb_base, _, scale, q0, shocks = books
    base = chip_smoke.base_book_totals(mb_base, q0, shocks)
    assert base.shape == (S,)
    assert chip_smoke.tile_linearity_error(
        tiled_out["pvs"], base, scale) < 1e-11


def test_tile_linearity_detects_a_wrong_scale(books, tiled_out):
    mb_base, _, scale, q0, shocks = books
    base = chip_smoke.base_book_totals(mb_base, q0, shocks)
    assert chip_smoke.tile_linearity_error(
        tiled_out["pvs"], base, scale * 1.001) > 1e-4


def test_ladder_sum_equals_book_delta(books, tiled_out, ladders):
    _, mb, _, _, _ = books
    assert ladders.shape == (mb.n_trades, mb.basket.n_quotes)
    assert chip_smoke.ladder_sum_error(
        ladders, tiled_out["delta"][0]) < 1e-10


def test_float32_matmul_ladders_within_1e6(books, ladders):
    _, mb, _, q0, _ = books
    l32 = make_per_trade_delta_fn(mb, dtype=jnp.float32,
                                  method="matmul")(q0)
    assert l32.dtype == jnp.float32
    assert chip_smoke.rel_err(l32, ladders) < 1e-6


def test_check_fails_on_nan_and_excess():
    chip_smoke.check("ok", 1e-12, 1e-10)
    for bad in (float("nan"), 1e-9):
        with pytest.raises(AssertionError):
            chip_smoke.check("bad", bad, 1e-10)


def test_rel_err_rejects_shape_mismatch():
    with pytest.raises(AssertionError, match="shape"):
        chip_smoke.rel_err(np.zeros(3), np.zeros(4))


def test_script_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "GPU backend" in proc.stderr


def test_dryrun_multichip_raises_with_too_few_devices():
    from __graft_entry__ import dryrun_multichip

    with pytest.raises(RuntimeError, match="needs 64 devices"):
        dryrun_multichip(64)
