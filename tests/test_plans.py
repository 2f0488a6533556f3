"""Plan persistence tests (io/plans.py): save/load roundtrips across
every plan family, metadata introspection, and the content-keyed
cache."""

import numpy as np
import pytest

import jax.numpy as jnp

from sparsela.io import generators
from sparsela.io.plans import (
    cached_plan,
    load_plan,
    plan_cache_key,
    plan_info,
    save_plan,
)
from sparsela.ops.spmv import plan_matrix, spmv, spmm


def _roundtrip_spmv(tmp_path, csr, dtype, **kwargs):
    plan = plan_matrix(csr, dtype=dtype, **kwargs)
    path = tmp_path / "p.plan"
    save_plan(path, plan, extra_meta={"nnz": csr.nnz})
    loaded = load_plan(path)
    assert type(loaded).__name__ == type(plan).__name__
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(csr.num_cols).astype(dtype))
    np.testing.assert_array_equal(
        np.asarray(spmv(plan, x)), np.asarray(spmv(loaded, x)))
    return plan, path


@pytest.mark.parametrize("fixture,dtype,kwargs", [
    ("rmat", np.float32, {}),                      # cuSPARSE CSR
    ("lap3d", np.float32, {}),                     # masked DIA
    ("lap3d", np.float64, {}),                     # f64 masked DIA
    ("rmat", np.float64, {}),                      # f64 cuSPARSE CSR
    ("lap2d", np.float32, {"L": 8}),               # DIA multi-RHS
    ("lap2d", np.float32, {"reorder": "auto"}),    # auto: keeps order
    ("scram", np.float32, {"reorder": "rcm"}),     # REAL ReorderedPlan
])
def test_roundtrip_families(tmp_path, fixture, dtype, kwargs):
    if fixture == "rmat":
        csr = generators.make_rmat(10, edge_factor=8, seed=3).to_csr()
    elif fixture == "lap3d":
        csr = generators.make_laplacian_grid3d(12, dtype=dtype).to_csr()
    elif fixture == "scram":
        from sparsela.ops.reorder import permute_symmetric

        base = generators.make_laplacian_grid2d(24, dtype=dtype).to_csr()
        csr = permute_symmetric(
            base, np.random.default_rng(7).permutation(base.num_rows))
    else:
        csr = generators.make_laplacian_grid2d(24, dtype=dtype).to_csr()
    plan, path = _roundtrip_spmv(tmp_path, csr, dtype, **kwargs)
    info = plan_info(path)
    assert info["class"] == type(plan).__name__
    assert info["nnz"] == csr.nnz
    if fixture == "scram":
        from sparsela.io.plans import load_plan
        from sparsela.ops.reorder import ReorderedPlan

        assert isinstance(plan, ReorderedPlan)
        # the LOADED plan keeps its permutation and ordering tag
        loaded = load_plan(path)
        assert loaded.order == plan.order
        np.testing.assert_array_equal(np.asarray(loaded.perm),
                                      np.asarray(plan.perm))


def test_roundtrip_spmm(tmp_path):
    csr = generators.make_laplacian_grid2d(24, dtype=np.float32).to_csr()
    plan = plan_matrix(csr, dtype=np.float32, L=4)
    save_plan(tmp_path / "m.plan", plan)
    loaded = load_plan(tmp_path / "m.plan")
    rng = np.random.default_rng(1)
    X = jnp.asarray(
        rng.standard_normal((csr.num_cols, 4)).astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(spmm(plan, X)), np.asarray(spmm(loaded, X)))


def test_rejects_foreign_files(tmp_path):
    p = tmp_path / "x.plan"
    import pickle

    with open(p, "wb") as f:
        pickle.dump({"magic": "other"}, f)
    with pytest.raises(ValueError, match="not a sparsela plan"):
        load_plan(p)


def test_cache_key_tracks_content_and_kwargs():
    a = generators.make_laplacian_grid2d(16, dtype=np.float32).to_csr()
    b = generators.make_laplacian_grid2d(16, dtype=np.float32).to_csr()
    assert plan_cache_key(a) == plan_cache_key(b)
    assert plan_cache_key(a, dtype=np.float32) != plan_cache_key(
        a, dtype=np.float64)
    c = generators.make_laplacian_grid2d(17, dtype=np.float32).to_csr()
    assert plan_cache_key(a) != plan_cache_key(c)
    # same pattern, different values -> different key
    import dataclasses

    d = dataclasses.replace(
        a, values=np.asarray(a.values) * 2.0)
    assert plan_cache_key(a) != plan_cache_key(d)


def test_cached_plan_hits_disk(tmp_path, monkeypatch):
    csr = generators.make_laplacian_grid2d(16, dtype=np.float32).to_csr()
    calls = {"n": 0}
    import sys

    # the ops package re-exports the spmv FUNCTION under the submodule
    # name, so `import sparsela.ops.spmv as m` binds the function
    spmv_mod = sys.modules["sparsela.ops.spmv"]
    real = spmv_mod.plan_matrix

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(spmv_mod, "plan_matrix", counting)
    p1 = cached_plan(csr, tmp_path, dtype=np.float32)
    p2 = cached_plan(csr, tmp_path, dtype=np.float32)
    assert calls["n"] == 1
    assert type(p1).__name__ == type(p2).__name__
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal(csr.num_cols).astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(spmv(p1, x)), np.asarray(spmv(p2, x)))
