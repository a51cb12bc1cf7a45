"""Synthetic rating matrices shaped like the reference workloads.

A copy of the numpy path of the JAX package's data/synthetic.py: the same
seed gives the same matrices. Ratings come from a planted low-rank model
(so ALS convergence is checkable), rows and columns are drawn from
Zipf-like weights (the heavy degree skew of the real datasets), and
duplicate (row, col) pairs are dropped, so the achieved nnz can fall
below the request: read the counts off the returned matrices.

The heavy exact steps (the inverse-CDF lookups, the de-duplication, the
factor-row gathers, the sorts) run through PyTorch's multi-threaded CPU kernels; they give
the same values as the numpy calls they replace, so the random streams
and the outputs are unchanged.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from cumf_als_tpu_torch.utils.io import COOMatrix, CSRMatrix, coo_to_csr


def _zipf_cdf(size: int, skew: float, rng) -> np.ndarray:
    w = np.arange(1, size + 1, dtype=np.float64) ** (-skew)
    rng.shuffle(w)
    return np.cumsum(w / w.sum())


def _searchsorted(cdf: np.ndarray, q: np.ndarray) -> np.ndarray:
    """np.searchsorted(cdf, q) (side "left") as int64, multi-threaded."""
    return torch.searchsorted(torch.from_numpy(cdf),
                              torch.from_numpy(q)).numpy()


def _unique(a: np.ndarray) -> np.ndarray:
    """np.unique(a) (sorted), multi-threaded and without numpy 2.3's
    hash-based pass, which takes minutes at 1e8 keys."""
    return torch.unique(torch.from_numpy(a), sorted=True).numpy()


def _take(table: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """table[idx] along the first axis, multi-threaded."""
    return torch.from_numpy(table).index_select(
        0, torch.from_numpy(idx).long()).numpy()


def synthetic_ratings(
    m: int,
    n: int,
    nnz: int,
    nnz_test: int,
    rank: int = 10,
    noise: float = 0.1,
    skew: Union[float, Tuple[float, float]] = 1.0,
    rating_range: Tuple[float, float] = (1.0, 5.0),
    seed: int = 0,
    signal_scale: float = 1.0,
) -> Tuple[CSRMatrix, COOMatrix]:
    """Sample (train CSR, test COO) from a planted rank-`rank` model;
    `skew` is one Zipf exponent or a (row_skew, col_skew) pair."""
    rng = np.random.RandomState(seed)
    row_skew, col_skew = (skew if isinstance(skew, tuple) else (skew, skew))
    u = (signal_scale * rng.standard_normal((m, rank)).astype(np.float32)
         / np.sqrt(rank))
    v = rng.standard_normal((n, rank)).astype(np.float32)

    lo, hi = rating_range
    total = nnz + nnz_test
    cdf_row = _zipf_cdf(m, row_skew, rng)
    cdf_col = _zipf_cdf(n, col_skew, rng)

    # Oversample in chunks, de-duplicate (row, col) keys incrementally.
    want = int(total * 1.25) + 16
    keys_parts = []
    seen = 0
    for _ in range(8):  # retry rounds for heavy-duplication regimes
        r = _searchsorted(cdf_row, rng.random_sample(want))
        c = _searchsorted(cdf_col, rng.random_sample(want))
        keys_parts.append(r * n + c)
        keys = _unique(np.concatenate(keys_parts))
        seen = keys.shape[0]
        if seen >= total:
            break
        want = min(int((total - seen) * 2.0) + 16, 4 * total)
    keys = _take(keys, rng.permutation(seen)[:min(seen, total)])
    total = keys.shape[0]
    nnz = min(nnz, total - min(nnz_test, total // 10))
    nnz_test = total - nnz
    rows = (keys // n).astype(np.int32)
    cols = (keys % n).astype(np.int32)

    raw = np.einsum("ij,ij->i", _take(u, rows), _take(v, cols))
    raw = raw + noise * rng.standard_normal(total).astype(np.float32)
    # Affine-map to the rating range and round to halves like real stars.
    mid, half = (hi + lo) / 2.0, (hi - lo) / 2.0
    vals = np.clip(mid + half * raw / 2.0, lo, hi)
    vals = (np.round(vals * 2.0) / 2.0).astype(np.float32)

    tr = np.ones(total, bool)
    tr[rng.choice(total, size=nnz_test, replace=False)] = False
    train = coo_to_csr(COOMatrix(row=rows[tr], col=cols[tr], data=vals[tr],
                                 num_rows=m, num_cols=n))
    te = ~tr
    test = COOMatrix(row=rows[te], col=cols[te], data=vals[te],
                     num_rows=m, num_cols=n)
    return train, test


def init_factors(m: int, n: int, f: int, seed: int = 0,
                 init_scale: float = 0.2) -> Tuple[np.ndarray, np.ndarray]:
    """Initial factors: theta ~ init_scale * U(0, 1), X = 0."""
    rng = np.random.RandomState(seed)
    theta = (init_scale * rng.random_sample((n, f))).astype(np.float32)
    x = np.zeros((m, f), dtype=np.float32)
    return x, theta


# Workload-shaped datasets (shapes and rating scales of the real
# datasets; the *_cal entries pin the planted model's noise so the
# converged test RMSE lands near the published accuracy regime — their
# parameters are the JAX package's).
WORKLOAD_SHAPES = {
    "ml10m": dict(m=71567, n=65133, nnz=9_000_048, nnz_test=1_000_006,
                  skew=(0.45, 0.45), rating_range=(0.5, 5.0)),
    "netflix": dict(m=17770, n=480_189, nnz=99_072_112,
                    nnz_test=1_408_395, skew=(0.5, 0.35),
                    rating_range=(1.0, 5.0)),
    "yahoo": dict(m=1_000_990, n=624_961, nnz=252_800_275,
                  nnz_test=4_003_960, skew=(0.45, 0.4),
                  rating_range=(0.0, 100.0)),
    # hugewiki at 1/25 scale: same tall-skinny shape (m >> n), the
    # out-of-core X regime; quick smoke form of the full workload
    "hugewiki_mini": dict(m=2_000_000, n=39_780, nnz=124_000_000,
                          nnz_test=2_000_000, skew=(0.35, 0.45),
                          rating_range=(1.0, 5.0)),
    # the full hugewiki workload (reference hugewiki.cu:27-42): 3.1B
    # training ratings; all flat indexing is int64 (nnz > 2^31). The
    # JAX package generates it with its native generator; this numpy
    # path makes full scale impractical until the port has one (ROADMAP
    # A10)
    "hugewiki": dict(m=50_082_603, n=39_780, nnz=3_101_144_313,
                     nnz_test=344_573_330, skew=(0.35, 0.45),
                     rating_range=(1.0, 5.0)),
    "netflix_cal": dict(m=17770, n=480_189, nnz=99_072_112,
                        nnz_test=1_408_395, skew=(0.5, 0.35),
                        rating_range=(1.0, 5.0), rank=10,
                        noise=0.92, signal_scale=0.6),
    "ml10m_cal": dict(m=71567, n=65133, nnz=9_000_048,
                      nnz_test=1_000_006, skew=(0.45, 0.45),
                      rating_range=(0.5, 5.0), rank=10,
                      noise=0.61, signal_scale=0.6),
    "yahoo_cal": dict(m=1_000_990, n=624_961, nnz=252_800_275,
                      nnz_test=4_003_960, skew=(0.45, 0.4),
                      rating_range=(0.0, 100.0), rank=10,
                      noise=0.86, signal_scale=0.6),
}


def workload_ratings(name: str, scale: float = 1.0, seed: int = 0,
                     rank: Optional[int] = None,
                     noise: Optional[float] = None, **overrides):
    """Synthetic dataset shaped like a named workload, optionally scaled
    down (scale < 1). Planted-model parameters: explicit arguments >
    the entry's own > the defaults (rank 10, noise 0.35)."""
    shp = dict(WORKLOAD_SHAPES[name])
    if scale != 1.0:
        for k in ("m", "n", "nnz", "nnz_test"):
            shp[k] = max(8, int(shp[k] * scale))
    params = {}
    for k in ("rank", "noise", "signal_scale"):
        if k in shp:
            params[k] = shp.pop(k)
    if rank is not None:
        params["rank"] = rank
    if noise is not None:
        params["noise"] = noise
    params.update(overrides)
    params.setdefault("rank", 10)
    params.setdefault("noise", 0.35)
    return synthetic_ratings(seed=seed, **params, **shp)
