"""Staged (independently-compiled region programs) flagship risk pass
vs the monolithic jit — make_staged_multibook_fn must reproduce
make_multibook_fn exactly on every dispatch path (plain jit, kept AOT
executables, multi-chunk scenario batching, delta-only), since the split
only moves the jit cut points (structured_risk.make_structured_parts).

The flagship monolith is the largest compile in the package; the staged
regions are smaller programs that precompile concurrently.
"""

import numpy as np
import pytest

from adrates_tpu.parallel import (compile_multibook, make_multibook_fn,
                                  make_staged_multibook_fn,
                                  tile_multibook, warmup_multibook)
from adrates_tpu.utils import CurrencyTypes

from multibook_cases import build_model, trades_for

pytestmark = pytest.mark.slow

S = 5


@pytest.fixture(scope="module")
def book():
    model = build_model()
    mb = compile_multibook(trades_for(model), model,
                           base_currency=CurrencyTypes.USD, n_buckets=2)
    rng = np.random.default_rng(0)
    shocks = rng.normal(0.0, 1e-3, (S, mb.basket.n_quotes))
    q0 = np.asarray(mb.basket.quotes0)
    ref = make_multibook_fn(mb)(q0, shocks)
    return mb, q0, shocks, {k: np.asarray(v) for k, v in ref.items()}


def _assert_matches(ref, out, keys=("pvs", "delta", "gamma")):
    for k in keys:
        a, b = ref[k], np.asarray(out[k])
        assert a.shape == b.shape
        scale = max(1.0, np.max(np.abs(a)))
        np.testing.assert_allclose(b / scale, a / scale, rtol=0,
                                   atol=1e-12, err_msg=k)


class TestStagedRisk:
    def test_jit_dispatch_matches_monolith(self, book):
        mb, q0, shocks, ref = book
        _assert_matches(ref, make_staged_multibook_fn(mb)(q0, shocks))

    def test_aot_executables_match(self, book):
        """precompile() keeps the compiled region executables and fn()
        dispatches through them (lower().compile() does not seed the
        jit cache — the handles ARE the warm path)."""
        mb, q0, shocks, ref = book
        fn = make_staged_multibook_fn(mb)
        fn.precompile(S, parallel=True)
        assert set(fn.programs) == {"A", "B", "C1", "C2", "D", "P"}
        _assert_matches(ref, fn(q0, shocks))

    def test_multichunk_padding(self, book):
        """S=5 through chunk=2 programs: 3 chunks, the last zero-padded
        on the host and trimmed after the device concat."""
        mb, q0, shocks, ref = book
        fn = make_staged_multibook_fn(mb, max_chunk=2)
        _assert_matches(ref, fn(q0, shocks))

    def test_aot_multichunk(self, book):
        mb, q0, shocks, ref = book
        fn = make_staged_multibook_fn(mb, max_chunk=2)
        fn.precompile(S, parallel=False)
        _assert_matches(ref, fn(q0, shocks))

    def test_delta_only(self, book):
        mb, q0, shocks, ref = book
        out = make_staged_multibook_fn(mb, want_gamma=False)(q0, shocks)
        assert "gamma" not in out
        _assert_matches(ref, out, keys=("pvs", "delta"))

    def test_warmup_staged(self, book):
        mb, q0, shocks, ref = book
        fn = warmup_multibook(mb, S, staged=True, parallel=True)
        _assert_matches(ref, fn(q0, shocks))

    def test_tiled_book(self, book):
        """Lazy TileSpec books expand in-graph through the staged PV
        sweep exactly as through the monolith."""
        mb, q0, shocks, _ = book
        scale = np.asarray([1.0, 2.5, 0.5])
        mbt = tile_multibook(mb, 3, notional_scale=scale)
        ref = make_multibook_fn(mbt)(q0, shocks)
        out = make_staged_multibook_fn(mbt)(q0, shocks)
        _assert_matches({k: np.asarray(v) for k, v in ref.items()}, out)

    def test_requires_stage_topology(self, book):
        mb, _, _, _ = book
        stages = mb.basket._stages
        mb.basket._stages = None
        try:
            with pytest.raises(Exception, match="batch_curves"):
                make_staged_multibook_fn(mb)
        finally:
            mb.basket._stages = stages

    def test_save_load_executables(self, book, tmp_path):
        """The shipped cold-start artifact: serialized region
        executables load into a FRESH staged fn (no precompile, no jit
        dispatch) and reproduce the monolith exactly. Shape fingerprint
        mismatches raise rather than mis-dispatch."""
        mb, q0, shocks, ref = book
        fn = make_staged_multibook_fn(mb)
        fn.precompile(S, parallel=False)
        path = str(tmp_path / "execs.pkl")
        fn.save_executables(path)

        fresh = make_staged_multibook_fn(mb)
        assert not fresh.programs
        fresh.load_executables(path)
        assert set(fresh.programs) == {"A", "B", "C1", "C2", "D", "P"}
        _assert_matches(ref, fresh(q0, shocks))

        from adrates_tpu.utils.error import LibError
        other = make_staged_multibook_fn(mb, want_gamma=False)
        with pytest.raises(LibError, match="different book"):
            other.load_executables(path)

    def test_save_before_precompile_raises(self, book, tmp_path):
        mb, _, _, _ = book
        fn = make_staged_multibook_fn(mb)
        from adrates_tpu.utils.error import LibError
        with pytest.raises(LibError, match="precompile"):
            fn.save_executables(str(tmp_path / "x.pkl"))

    def test_trip_chunked_quad_form_matches(self, book, monkeypatch):
        """Force the trip-axis lax.map chunking (flagship trip counts
        OOM'd the unchunked [S, N, T] gather temporaries — BENCH_r05):
        tiny chunks with a padded tail must reproduce the monolith
        exactly (pad slots carry w=0 and index the t=0/df=1 slot)."""
        mb, q0, shocks, ref = book
        import adrates_tpu.parallel.multibook as mbmod
        assert int(mb.aggregate.trip_s.shape[0]) > 5
        monkeypatch.setattr(mbmod, "_TRIP_CHUNK", 4)
        _assert_matches(ref, make_staged_multibook_fn(mb)(q0, shocks))

    def test_grouped_term1_matches_ungrouped(self, book):
        """The signature-grouped quad form (term1 at each group's
        closed quote width — the staged B region's warm wall at
        flagship scale) must equal the full-N closed form exactly."""
        import jax
        import jax.numpy as jnp

        from adrates_tpu.parallel.multibook import (
            _agg_clamp, _gamma_quad_form, _gamma_quad_form_grouped,
            _term1_trip_groups)

        mb, q0, shocks, _ = book
        basket = mb.basket
        groups = _term1_trip_groups(basket, mb.aggregate)
        assert groups and len(groups) >= 2
        assert sum(g["tsel"].shape[0] for g in groups) \
            == int(mb.aggregate.trip_s.shape[0])

        grids = basket.grids
        params = basket.params
        agg = mb.aggregate
        cl = _agg_clamp(mb.clamp, mb.tile)
        qv = jnp.asarray(q0 + shocks[0])
        dfs, jvp = jax.linearize(lambda q: grids(q, params), qv)
        J = jax.vmap(jvp)(jnp.eye(q0.shape[0]))
        ref = np.asarray(_gamma_quad_form(J, dfs, agg, cl))
        out = np.asarray(_gamma_quad_form_grouped(J, dfs, agg, cl,
                                                  groups))
        np.testing.assert_allclose(
            out, ref, rtol=0, atol=1e-13 * (np.abs(ref).max() + 1.0))
