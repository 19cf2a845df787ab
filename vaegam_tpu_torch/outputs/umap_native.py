"""Native UMAP: fuzzy simplicial set + cross-entropy SGD layout.

The port's copy of ``vaegam_tpu.outputs.umap_native`` (that package
imports JAX): the published UMAP algorithm (McInnes, Healy & Melville,
arXiv:1802.03426) with the reference's latent-plot settings (n_neighbors=20,
min_dist=0.1, seed 42), which stands in for umap-learn where it is not
installed.  The graph construction, the a/b curve fit, the spectral
initialization and the trustworthiness gate are the JAX module's numpy code,
unchanged; the layout optimizer is written in torch on an explicit device.

As in the JAX module, two deliberate deviations from the umap-learn
implementation (not the algorithm): every due edge of an epoch is updated
from the epoch-start snapshot (umap-learn's ``parallel=True`` variant), and
the kNN is exact brute force (the latent sets here are ~10^2..10^4 rows x 32
dims).
"""

from __future__ import annotations

import time

import numpy as np
import torch

MIN_K_DIST_SCALE = 1e-3
SMOOTH_K_TOLERANCE = 1e-5


def knn_graph(x: np.ndarray, n_neighbors: int):
    """Exact kNN (self included as first neighbor, like umap-learn).

    Returns (indices [N,k], dists [N,k]) sorted ascending per row.
    """
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    sq = np.sum(x * x, axis=1)
    idx = np.empty((n, n_neighbors), dtype=np.int64)
    dists = np.empty((n, n_neighbors), dtype=np.float64)
    # row-chunked so peak memory is O(chunk x n), not O(n^2) — at the
    # module's 10^4-row upper range a full float64 matrix is ~800 MB
    chunk = max(1, min(n, int(2**27 // max(n, 1))))
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        d2 = sq[s:e, None] + sq[None, :] - 2.0 * (x[s:e] @ x.T)
        np.maximum(d2, 0.0, out=d2)
        d2[np.arange(e - s), np.arange(s, e)] = 0.0  # exact-zero self
        # distance (float noise in the Gram expansion would corrupt rho)
        part = np.argpartition(d2, n_neighbors - 1, axis=1)[:, :n_neighbors]
        pd = np.take_along_axis(d2, part, axis=1)
        order = np.argsort(pd, axis=1, kind="stable")
        idx[s:e] = np.take_along_axis(part, order, axis=1)
        dists[s:e] = np.sqrt(np.take_along_axis(pd, order, axis=1))
    # self must occupy column 0 (smooth_knn_dist skips it); argpartition
    # tie order can put another zero-distance duplicate there instead
    self_col = np.argmax(idx == np.arange(n)[:, None], axis=1)
    has_self = (idx == np.arange(n)[:, None]).any(axis=1)
    for i in np.nonzero(has_self & (self_col != 0))[0]:
        j = self_col[i]
        idx[i, [0, j]] = idx[i, [j, 0]]
        dists[i, [0, j]] = dists[i, [j, 0]]
    return idx, dists


def smooth_knn_dist(dists: np.ndarray, n_iter: int = 64):
    """Per-point (rho, sigma) via the binary search of UMAP §4.

    rho_i = distance to the nearest non-identical neighbor
    (local_connectivity=1); sigma_i solves
    sum_{j>=1} exp(-max(0, d_ij - rho_i)/sigma_i) = log2(k),
    with umap-learn's MIN_K_DIST_SCALE floor.  Column 0 (the self
    neighbor) is excluded from the sum, exactly like umap-learn's
    ``for j in range(1, k)`` loop — including it would shift every
    sigma to solve for log2(k)-1 over the real neighbors.
    """
    n, k = dists.shape
    target = np.log2(k)
    nonzero = np.where(dists > 0.0, dists, np.inf)
    rho = np.min(nonzero, axis=1)
    rho = np.where(np.isfinite(rho), rho, 0.0)

    lo = np.zeros(n)
    hi = np.full(n, np.inf)
    mid = np.ones(n)
    for _ in range(n_iter):
        psum = np.sum(np.exp(-np.maximum(dists[:, 1:] - rho[:, None], 0.0)
                             / mid[:, None]), axis=1)
        err = psum - target
        done = np.abs(err) < SMOOTH_K_TOLERANCE
        go_down = err > 0
        hi = np.where(~done & go_down, mid, hi)
        lo = np.where(~done & ~go_down, mid, lo)
        new_mid = np.where(np.isinf(hi), lo * 2.0, (lo + hi) / 2.0)
        mid = np.where(done, mid, new_mid)

    mean_d_row = np.mean(dists, axis=1)
    mean_d_all = np.mean(dists)
    floor = np.where(rho > 0.0, MIN_K_DIST_SCALE * mean_d_row,
                     MIN_K_DIST_SCALE * mean_d_all)
    return rho, np.maximum(mid, floor)


def fuzzy_simplicial_set(x: np.ndarray, n_neighbors: int, timings=None):
    """Symmetrized fuzzy neighbor graph (UMAP §4, fuzzy set union).

    Returns COO arrays (heads, tails, weights) with zero-weight and
    self edges removed.  A ``timings`` dict receives the host seconds of the
    kNN ("knn_s") and of the rest ("fuzzy_s").
    """
    import scipy.sparse as sp

    t0 = time.perf_counter()
    n = len(x)
    idx, dists = knn_graph(x, n_neighbors)
    t1 = time.perf_counter()
    rho, sigma = smooth_knn_dist(dists)

    w = np.exp(-np.maximum(dists - rho[:, None], 0.0) / sigma[:, None])
    rows = np.repeat(np.arange(n), idx.shape[1])
    cols = idx.ravel()
    vals = w.ravel().copy()
    vals[rows == cols] = 0.0  # self membership is 0 in umap-learn

    # sparse fuzzy union P + P^T - P o P^T on the ~k*n kNN edges (a
    # dense n x n intermediate would be ~800 MB float64 at 10^4 rows)
    p = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    u = (p + p.T - p.multiply(p.T)).tocoo()
    keep = u.data > 0.0
    if timings is not None:
        timings["knn_s"] = t1 - t0
        timings["fuzzy_s"] = time.perf_counter() - t1
    return u.row[keep], u.col[keep], u.data[keep]


def find_ab_params(spread: float = 1.0, min_dist: float = 0.1):
    """Fit 1/(1 + a d^{2b}) to the min_dist/spread membership curve.

    Same least-squares fit as umap.umap_.find_ab_params; for the
    reference settings (1.0, 0.1) this lands at a~1.577, b~0.8951.
    """
    from scipy.optimize import curve_fit

    def curve(d, a, b):
        return 1.0 / (1.0 + a * d ** (2 * b))

    xv = np.linspace(0, spread * 3, 300)
    yv = np.where(xv < min_dist, 1.0,
                  np.exp(-(xv - min_dist) / spread))
    (a, b), _ = curve_fit(curve, xv, yv)
    return float(a), float(b)


def spectral_init(n: int, heads, tails, weights, dim: int = 2,
                  seed: int = 42) -> np.ndarray:
    """Laplacian-eigenmap initialization of the embedding (UMAP §4).

    Eigenvectors 2..dim+1 of the symmetric-normalized graph Laplacian,
    scaled so the widest coordinate spans +-10 with tiny seed noise —
    umap-learn's `spectral_layout` + noise convention.
    """
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    rng = np.random.default_rng(seed)
    g = sp.coo_matrix((weights, (heads, tails)), shape=(n, n)).tocsr()
    deg = np.asarray(g.sum(axis=1)).ravel()
    inv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    lap = sp.identity(n) - sp.diags(inv_sqrt) @ g @ sp.diags(inv_sqrt)
    try:
        vals, vecs = spla.eigsh(lap, k=dim + 1, sigma=0.0, which="LM",
                                v0=np.ones(n))
        init = vecs[:, np.argsort(vals)[1:dim + 1]]
    except Exception:  # non-converged / disconnected graph
        init = rng.uniform(-10.0, 10.0, size=(n, dim))
    expansion = 10.0 / max(np.abs(init).max(), 1e-12)
    return (init * expansion
            + rng.normal(scale=1e-4, size=(n, dim))).astype(np.float32)


def make_epochs_per_sample(weights: np.ndarray, n_epochs: int):
    """umap-learn's edge-sampling schedule: edge e fires every
    w_max / w_e epochs (high-weight edges every epoch)."""
    w = np.asarray(weights, dtype=np.float64)
    return np.where(w > 0, w.max() / np.maximum(w, 1e-12), np.inf)


def optimize_layout(init: np.ndarray, heads: np.ndarray,
                    tails: np.ndarray, epochs_per_sample: np.ndarray,
                    a: float, b: float, n_epochs: int = 500,
                    negative_sample_rate: int = 5, gamma: float = 1.0,
                    initial_alpha: float = 1.0, seed: int = 42,
                    device="cpu", negatives=None) -> np.ndarray:
    """Cross-entropy SGD layout (UMAP §4), one loop over epochs on `device`.

    Attraction on due edges: grad = -2ab d^{2(b-1)} / (1 + a d^{2b}),
    applied to both endpoints (umap's move_other=True); repulsion on
    negative_sample_rate uniform negatives per due edge, applied to the
    head: grad = 2 gamma b / ((0.001 + d^2)(1 + a d^{2b})); per-dim
    gradient clip +-4; learning rate decaying linearly from initial_alpha
    to 0.  Both terms read the epoch-start snapshot (the negatives' yk as
    well), and the updates land as ``index_add_`` scatter-adds.

    The negatives are drawn from a ``torch.Generator`` seeded by `seed` on
    `device`, or injected as an int tensor of shape (n_epochs, E, n_neg).
    On CUDA ``index_add_`` sums with atomics, so a run is bit-reproducible
    on the CPU only; on the card check the layout's quality, not its bits.
    """
    device = torch.device(device)
    emb = torch.as_tensor(np.asarray(init), dtype=torch.float32, device=device)
    hd = torch.as_tensor(np.asarray(heads), dtype=torch.long, device=device)
    tl = torch.as_tensor(np.asarray(tails), dtype=torch.long, device=device)
    eps = torch.as_tensor(np.asarray(epochs_per_sample), dtype=torch.float32,
                          device=device)
    n, n_edges, n_neg = init.shape[0], hd.shape[0], int(negative_sample_rate)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    next_at = eps.clone()
    for ep in range(n_epochs):
        due = next_at <= ep
        next_at = torch.where(due, next_at + eps, next_at)
        alpha = initial_alpha * (1.0 - ep / n_epochs)
        duef = due.to(torch.float32)[:, None]

        yi, yj = emb[hd], emb[tl]
        diff = yi - yj
        d2 = torch.sum(diff * diff, dim=1, keepdim=True)
        pw = torch.pow(torch.clamp(d2, min=1e-12), b)
        att = torch.where(d2 > 0.0, (-2.0 * a * b * pw / d2) / (a * pw + 1.0),
                          torch.zeros_like(d2))
        g_att = torch.clamp(att * diff, -4.0, 4.0) * duef * alpha
        emb_new = emb.index_add(0, hd, g_att).index_add_(0, tl, -g_att)

        if negatives is None:
            negs = torch.randint(0, n, (n_edges, n_neg), generator=gen,
                                 device=device)
        else:
            negs = torch.as_tensor(negatives[ep], dtype=torch.long, device=device)
        yk = emb[negs]                       # epoch-start snapshot
        diff_n = yi[:, None, :] - yk
        d2n = torch.sum(diff_n * diff_n, dim=2, keepdim=True)
        pwn = torch.pow(torch.clamp(d2n, min=1e-12), b)
        rep = (2.0 * gamma * b) / ((0.001 + d2n) * (a * pwn + 1.0))
        g_rep = torch.where(d2n > 0.0, torch.clamp(rep * diff_n, -4.0, 4.0),
                            torch.zeros_like(diff_n))
        g_rep = torch.sum(g_rep, dim=1) * duef * alpha
        emb = emb_new.index_add_(0, hd, g_rep)
    return emb.cpu().numpy()


def umap_embed(x: np.ndarray, n_neighbors: int = 20,
               min_dist: float = 0.1, n_components: int = 2,
               n_epochs: int | None = None, seed: int = 42, device="cpu",
               timings=None):
    """UMAP(x) with the reference's latent-plot settings as defaults.

    Mirrors umap.UMAP(n_components=2, n_neighbors=20, min_dist=0.1,
    random_state=42).fit_transform (reference vae_reg_GP.py:556-559); the
    graph is built on the host and the layout optimized on `device`.  A
    ``timings`` dict receives host seconds of the kNN, the fuzzy set, the
    initialization (a/b fit and spectral init) and the layout.
    """
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if n <= n_neighbors + 1:
        raise ValueError("too few samples for the kNN graph")
    timings = {} if timings is None else timings
    heads, tails, weights = fuzzy_simplicial_set(x, n_neighbors, timings)
    t0 = time.perf_counter()
    if n_epochs is None:
        n_epochs = 500 if n <= 10000 else 200
    # umap drops edges too weak to fire even once in n_epochs
    keep = weights >= weights.max() / float(n_epochs)
    heads, tails, weights = heads[keep], tails[keep], weights[keep]
    a, b = find_ab_params(1.0, min_dist)
    init = spectral_init(n, heads, tails, weights, n_components, seed)
    eps = make_epochs_per_sample(weights, n_epochs)
    t1 = time.perf_counter()
    out = optimize_layout(init, heads, tails, eps, a, b, n_epochs=n_epochs,
                          seed=seed, device=device)
    timings.update(init_s=t1 - t0, layout_s=time.perf_counter() - t1)
    return out


def trustworthiness(x: np.ndarray, emb: np.ndarray,
                    n_neighbors: int = 5) -> float:
    """Trustworthiness of an embedding (Venna & Kaski 2001).

    T(k) = 1 - 2/(n k (2n - 3k - 1)) * sum_i sum_{j in U_i(k)} (r(i,j) - k)
    where U_i(k) are the k nearest neighbors of i in the EMBEDDING that are
    not among its k nearest in the ORIGINAL space, and r(i,j) is j's rank by
    original-space distance from i (self excluded).  1.0 = every embedding
    neighborhood is faithful; 0.5 ~ random.  The quantitative fidelity gate
    for the latent-projection artifact.
    """
    x = np.asarray(x, dtype=np.float64)
    emb = np.asarray(emb, dtype=np.float64)
    n = len(x)
    if not 0 < n_neighbors < n / 2:
        raise ValueError("n_neighbors must be in (0, n/2)")

    def pairwise_sq(a):
        sq = np.sum(a * a, axis=1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * (a @ a.T)
        np.maximum(d2, 0.0, out=d2)
        np.fill_diagonal(d2, np.inf)  # exclude self from rankings
        return d2

    d_x = pairwise_sq(x)
    d_e = pairwise_sq(emb)
    # rank of every point by original-space distance (0 = nearest)
    ranks_x = np.argsort(np.argsort(d_x, axis=1, kind="stable"),
                         axis=1, kind="stable")
    emb_nn = np.argsort(d_e, axis=1, kind="stable")[:, :n_neighbors]
    rank_of_emb_nn = np.take_along_axis(ranks_x, emb_nn, axis=1)
    # penalize embedding neighbors whose original rank falls outside top-k
    penalty = np.maximum(rank_of_emb_nn - (n_neighbors - 1), 0).sum()
    norm = 2.0 / (n * n_neighbors * (2.0 * n - 3.0 * n_neighbors - 1.0))
    return float(1.0 - norm * penalty)
