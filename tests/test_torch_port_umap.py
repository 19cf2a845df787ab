"""The port's native UMAP (vaegam_tpu_torch/outputs/umap_native.py) against
the JAX package's.

The numpy stages must equal the JAX module's exactly; the torch layout
optimizer, given JAX's own negatives and the same initialization, must
equal the JAX layout; and the port's UMAP on the CPU must pass the JAX
package's gates (tests/test_umap_native.py): determinism, cluster
separation, trustworthiness > 0.85.
"""

import jax
import numpy as np
import pytest

from vaegam_tpu.outputs import umap_native as jax_un

from vaegam_tpu_torch.outputs import latents
from vaegam_tpu_torch.outputs import umap_native as un


def _two_clusters(n_per=60, dim=32, sep=8.0, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n_per, dim))
    b = rng.normal(size=(n_per, dim))
    b[:, 0] += sep
    return np.concatenate([a, b]), np.concatenate([np.zeros(n_per), np.ones(n_per)])


def _jax_negatives(n_epochs, n_edges, n, n_neg=5, seed=42):
    """JAX's key chain: PRNGKey(seed), a split each epoch, randint of (E, n_neg)."""
    key, negs = jax.random.PRNGKey(seed), []
    for _ in range(n_epochs):
        key, sub = jax.random.split(key)
        negs.append(np.asarray(jax.random.randint(sub, (n_edges, n_neg), 0, n)))
    return np.stack(negs)


@pytest.fixture(scope="module")
def graph():
    """The two-cluster fixture's graph at n_neighbors 15, 50 epochs."""
    x, _ = _two_clusters()
    h, t, w = un.fuzzy_simplicial_set(x, 15)
    keep = w >= w.max() / 50.0
    h, t, w = h[keep], t[keep], w[keep]
    a, b = un.find_ab_params(1.0, 0.1)
    init = un.spectral_init(len(x), h, t, w, 2, 42)
    return x, h, t, un.make_epochs_per_sample(w, 50), a, b, init


@pytest.mark.parametrize("name,args", [
    ("knn_graph", lambda x: (x, 15)),
    ("smooth_knn_dist", lambda x: (jax_un.knn_graph(x, 15)[1],)),
    ("fuzzy_simplicial_set", lambda x: (x, 15)),
    ("find_ab_params", lambda x: (1.0, 0.1)),
    ("spectral_init", lambda x: (len(x), *jax_un.fuzzy_simplicial_set(x, 10), 2, 42)),
    ("make_epochs_per_sample", lambda x: (jax_un.fuzzy_simplicial_set(x, 10)[2], 200)),
    ("trustworthiness", lambda x: (x, x[:, :2] + 0.3 * x[:, 2:4], 7)),
])
def test_numpy_stages_equal_jax(name, args):
    x = np.random.default_rng(3).normal(size=(90, 6))
    a = args(x)
    got, want = getattr(un, name)(*a), getattr(jax_un, name)(*a)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_layout_equals_jax_with_jax_negatives(graph):
    """JAX's key chain (PRNGKey(seed), split each epoch, randint of
    (E, n_neg)) drawn here and injected into the torch optimizer: from the
    same init the layouts agree to atol 1e-4.

    The run is 4 epochs, not 50: the layout is chaotic.  XLA's float32 pow
    is libm's powf and torch's is its own vectorized one; they differ by
    one ulp on ~2% of inputs, and a difference grows ~6x an epoch through
    the repulsion of near points (measured on this fixture: 6.7e-6 after
    3 epochs, 1.1e-5 after 4, 4.6e-4 after 6, O(1) after 50, with or
    without the negatives).  Quality over a full run is held by the gates
    below."""
    x, h, t, eps, a, b, init = graph
    n_epochs = 4
    want = jax_un.optimize_layout(init, h, t, eps, a, b, n_epochs=n_epochs, seed=42)
    got = un.optimize_layout(init, h, t, eps, a, b, n_epochs=n_epochs, seed=42,
                             device="cpu",
                             negatives=_jax_negatives(n_epochs, len(h), len(x)))
    assert got.dtype == np.float32 and got.shape == init.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# faults the 4-epoch comparison must catch, as (source line, its faulty form)
_LAYOUT_FAULTS = {
    # the repulsion reads the half-updated emb_new, not the epoch-start snapshot
    "snapshot": [("yk = emb[negs]", "yk = emb_new[negs]"),
                 ("diff_n = yi[:, None, :] - yk", "diff_n = emb_new[hd][:, None, :] - yk")],
    "attraction_sign": [("emb.index_add(0, hd, g_att).index_add_(0, tl, -g_att)",
                         "emb.index_add(0, hd, -g_att).index_add_(0, tl, g_att)")],
}


@pytest.mark.parametrize("fault", sorted(_LAYOUT_FAULTS))
def test_layout_comparison_catches_faults(graph, fault):
    """The 4-epoch comparison above can fail: the port's optimize_layout
    with one fault put into its source misses JAX's layout by far more
    than atol 1e-4."""
    import inspect
    import textwrap

    x, h, t, eps, a, b, init = graph
    src = textwrap.dedent(inspect.getsource(un.optimize_layout))
    for line, faulty in _LAYOUT_FAULTS[fault]:
        assert src.count(line) == 1, line
        src = src.replace(line, faulty)
    scope = dict(vars(un))
    exec(compile(src, un.__file__, "exec"), scope)
    negs = _jax_negatives(4, len(h), len(x))
    want = jax_un.optimize_layout(init, h, t, eps, a, b, n_epochs=4, seed=42)
    got = scope["optimize_layout"](init, h, t, eps, a, b, n_epochs=4, seed=42,
                                   device="cpu", negatives=negs)
    assert np.abs(got - want).max() > 1e-2  # measured: 6.4 and 14


def test_port_umap_gates_on_the_cpu():
    """The JAX package's gates, on the port's own negatives: a fixed seed
    gives the same layout, the clusters separate (gap > 2 x spread), and
    trustworthiness exceeds 0.85 at k=5 and k=15."""
    x, labels = _two_clusters()
    timings = {}
    e1 = un.umap_embed(x, n_neighbors=15, n_epochs=200, seed=42, device="cpu",
                       timings=timings)
    e2 = un.umap_embed(x, n_neighbors=15, n_epochs=200, seed=42, device="cpu")
    np.testing.assert_array_equal(e1, e2)
    assert e1.shape == (len(x), 2) and np.isfinite(e1).all()
    ca, cb = e1[labels == 0], e1[labels == 1]
    gap = np.linalg.norm(ca.mean(0) - cb.mean(0))
    spread = max(np.linalg.norm(ca - ca.mean(0), axis=1).mean(),
                 np.linalg.norm(cb - cb.mean(0), axis=1).mean())
    assert gap > 2.0 * spread
    assert un.trustworthiness(x, e1, n_neighbors=15) > 0.85
    assert un.trustworthiness(x, e1, n_neighbors=5) > 0.85
    assert sorted(timings) == ["fuzzy_s", "init_s", "knn_s", "layout_s"]
    with pytest.raises(ValueError):
        un.umap_embed(np.zeros((5, 3)), n_neighbors=20)


def test_project_2d_names_its_backend():
    """Over 25 rows the chain takes the native UMAP and says so; at 25 rows
    or fewer it takes PCA."""
    x, _ = _two_clusters(n_per=30)
    out, backend = latents._project_2d(x, "cpu")
    assert backend == "umap_native" and out.shape == (len(x), 2)
    out, backend = latents._project_2d(x[:20], "cpu")
    assert backend == "pca" and out.shape == (20, 2)
