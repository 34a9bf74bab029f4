"""interp_df_query pad-node math, tested DIRECTLY.

The bucketed host-boundary query pads the node grid with synthetic far
nodes claimed clamp-exact "for any query before t_last + 500y"
(ops/interpolation.py:_pad_nodes). It sits under EVERY df() call, so a
silent off-by-one would mis-price every curve query. This file pins the
claim itself: padded == unpadded to f64 noise across schemes x
node-bucket boundaries x query buckets x exact-knot / beyond-last-knot
queries x negative rates (the LINEAR_ZERO pad derives r_last from the
last node).
"""

import numpy as np
import pytest

from adrates_tpu.ops.interpolation import (_NODE_BUCKETS, _QUERY_BUCKETS,
                                           interp_df, interp_df_query)
from adrates_tpu.utils import InterpTypes

SCHEMES = [InterpTypes.FLAT_FWD_RATES, InterpTypes.LINEAR_ZERO_RATES,
           InterpTypes.LINEAR_FWD_RATES]

# node counts straddling every bucket boundary (64, 256) plus small and
# exact-bucket sizes; 1024+ nodes never bucket-pad (n > last bucket
# stays unpadded), so 1023/1024/1025 adds nothing
NODE_COUNTS = [5, 63, 64, 65, 255, 256, 257]


def _curve(n, negative=False, seed=0):
    """n-node grid (t=0 df=1 first) with smooth positive or negative
    zero rates."""
    rng = np.random.default_rng(seed + n)
    times = np.concatenate([[0.0], np.sort(rng.uniform(0.05, 60.0,
                                                       n - 1))])
    base = -0.012 if negative else 0.035
    rates = base + 0.01 * np.sin(times / 7.0)
    dfs = np.exp(-rates * times)
    dfs[0] = 1.0
    return times, dfs


def _queries(times):
    """Exact knots, midpoints, sub-first-pillar, and beyond-last-knot
    (where the clamp/extrapolation must match the unpadded grid — the
    pad nodes begin at t_last + 500y, unreachable by real dates)."""
    t_last = times[-1]
    mids = 0.5 * (times[1:] + times[:-1])
    return np.concatenate([
        times,                         # every exact knot
        mids[:: max(1, len(mids) // 8)],
        [times[1] * 0.5],              # before the first pillar
        [t_last + 0.5, t_last + 10.0, t_last + 100.0, t_last + 400.0],
    ])


@pytest.mark.parametrize("scheme", SCHEMES, ids=lambda s: s.name)
@pytest.mark.parametrize("n", NODE_COUNTS)
@pytest.mark.parametrize("negative", [False, True],
                         ids=["pos_rates", "neg_rates"])
def test_padded_equals_unpadded(scheme, n, negative):
    times, dfs = _curve(n, negative)
    q = _queries(times)
    want = np.asarray(interp_df(q, times, dfs, scheme))
    got = np.asarray(interp_df_query(q, times, dfs, scheme))
    np.testing.assert_allclose(got, want, rtol=5e-15, atol=0.0)
    # exact-knot guard through the padded grid: stored DFs verbatim
    knots = np.asarray(interp_df_query(times, times, dfs, scheme))
    np.testing.assert_array_equal(knots, dfs)


@pytest.mark.parametrize("qn", [1, 3, 4, 5, 31, 32, 33])
def test_query_bucket_boundaries(qn):
    """Query-vector padding (duplicate-last to the next bucket) must be
    invisible at every bucket edge, scalar queries included."""
    times, dfs = _curve(64)
    rng = np.random.default_rng(qn)
    q = np.sort(rng.uniform(0.0, times[-1] + 5.0, qn))
    for scheme in SCHEMES:
        want = np.asarray(interp_df(q, times, dfs, scheme))
        got = np.asarray(interp_df_query(q, times, dfs, scheme))
        np.testing.assert_allclose(got, want, rtol=5e-15, atol=0.0)
    # scalar in, scalar out
    s = float(interp_df_query(np.float64(q[0]), times, dfs,
                              InterpTypes.FLAT_FWD_RATES))
    w = float(interp_df(np.float64(q[0]), times, dfs,
                        InterpTypes.FLAT_FWD_RATES))
    assert s == pytest.approx(w, rel=5e-15)


def test_bucket_constants_unchanged():
    """The claim 'pads begin 500y past the last node' plus these bucket
    tables are what the test matrix above covers — fail loudly if the
    buckets change so the matrix is extended, not silently stale."""
    assert _NODE_BUCKETS == (64, 256, 1024)
    assert _QUERY_BUCKETS == (4, 32, 128, 512, 2048)
