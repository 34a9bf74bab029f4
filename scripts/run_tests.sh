#!/usr/bin/env bash
# Full partitioned test run (the suite exceeds any
# single pytest invocation's sane wall clock, so the partitions live in
# this script, not in folklore).
#
#   scripts/run_tests.sh quick   -> `pytest -m "not slow"`, the
#                                   default pre-commit gate
#   scripts/run_tests.sh full    -> quick + every slow partition,
#                                   sequentially
#
# Wall clock depends on the host: quick is ~4-5 min on a laptop-class multi-core CPU and
# ~9 min on a 1-vCPU cloud box; full is ~25-35 min laptop-class,
# ~35-45 min on 1 vCPU. Run partitions strictly SEQUENTIALLY — on
# small hosts parallel pytest invocations starve each other.
#
# Partitions are grouped so no single invocation exceeds ~10 min:
# test_multibook_core alone is the heaviest file (~7 min); the old
# unsplit test_multibook.py exceeded 590 s and is split into
# core / pertrade / sharded / collateral / blocks.

set -euo pipefail
cd "$(dirname "$0")/.."

MODE="${1:-quick}"

run() {
    echo "== pytest $*"
    python -m pytest "$@" -q --no-header
}

run tests/ -m "not slow"

if [ "$MODE" = "full" ]; then
    run tests/test_multibook_core.py
    run tests/test_multibook_pertrade.py tests/test_pertrade_blocks.py
    run tests/test_multibook_sharded.py
    run tests/test_staged_risk.py
    run tests/test_multibook_collateral.py
    run tests/test_curve_batching.py tests/test_curve_bootstrap.py
    run tests/test_jit_caching.py tests/test_marketdata.py
    run tests/test_xccy.py tests/test_parallel_book.py
fi
echo "ALL GREEN ($MODE)"
