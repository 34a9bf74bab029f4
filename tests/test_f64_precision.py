"""float64 precision gates (docs/f64_notes.md) on the CPU backend.

The same gates run on the GPU through ``chip_smoke.py``; they are
backend-agnostic, so here they re-verify the invariants on the CPU.
"""

import pytest

from adrates_tpu.f64_gates import GATES


@pytest.mark.parametrize("gate, bound", [g[1:] for g in GATES],
                         ids=[g[0] for g in GATES])
def test_f64_gate(gate, bound):
    assert gate() < bound
