"""How sparse is the dense [C*U] DF grid at flagship diversity?

The staged risk pass materializes [chunk, N, C*U] jacobians; at
flagship_v5 (U=4,337, C=12) that axis is 52k wide, which both caps the
scenario chunk and scales the term1/term2 FLOPs. But each curve only
ever serves the times ITS trades reference — this probe counts the
referenced (curve, time) pairs across every index table to size the win
of compacting the grid axis. Host-only (no device programs); run from
the repo root: python benchmarks/probe_grid_sparsity.py
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, ".")
from benchmarks.flagship_book import build_base_trades, build_model  # noqa: E402,E501


def main():
    rng = np.random.default_rng(7)
    model = build_model()
    trades, coll = build_base_trades(model, rng)
    from adrates_tpu.parallel import compile_multibook
    from adrates_tpu.utils import CurrencyTypes

    mb = compile_multibook(trades, model,
                           base_currency=CurrencyTypes.USD,
                           n_buckets=4, collateral_types=coll,
                           stage_buckets="coarse")
    U = mb.unique_times.shape[0]
    C = mb.basket.n_curves
    CU = C * U

    used = np.zeros(CU, dtype=bool)
    for b in mb.buckets:
        for name in ("fix_idx", "flt_pay_idx", "flt_start_idx",
                     "flt_end_idx"):
            idx = np.asarray(getattr(b, name)).ravel()
            used[idx] = True
    if mb.clamp is not None:
        for name in ("s_idx", "e_idx", "p_idx"):
            used[np.asarray(getattr(mb.clamp, name))] = True
    agg = mb.aggregate
    used[np.asarray(agg.w_lin) != 0.0] = True
    for name in ("trip_s", "trip_e", "trip_p"):
        used[np.asarray(getattr(agg, name))] = True

    per_curve = used.reshape(C, U).sum(axis=1)
    print(f"C={C} U={U} CU={CU}")
    print(f"referenced pairs: {used.sum()} "
          f"({used.sum() / CU:.1%} of dense)")
    print(f"per-curve counts: {per_curve.tolist()}")
    print(f"compaction factor: {CU / max(used.sum(), 1):.2f}x")


if __name__ == "__main__":
    main()
