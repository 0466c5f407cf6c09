"""The selection arithmetic of the kNN kernels (`csrc/knn_core.cuh`, behind
`csrc/knn.cu` and `csrc/knn_gather.cu`), modelled in numpy lane by lane
and held exactly against the plain versions (`knn_plain`,
`knn_gather_plain`) and the JAX package's Pallas kernels in interpret mode
(`knn_pallas`, `knn_gather_pallas`).

The model follows the kernels step for step: distances as
order-preserving uint32 keys; the k-th smallest key found bit by bit from
the top with one warp-wide count a bit (`search_kth`), stopping early
once the keys below its bound fit the candidate list; the keys below the
bound listed from per-lane masks, and ties at the k-th key in index
order by ballot prefix counts (`list_masked`, `compact_equal`); each
entry placed at its rank (`merge_candidates`); and, in `knn_gather`, the
cloud streamed in tiles, with tile keys at or above the carried k-th key
dropped before any selection.  The CUDA kernels are held to the plain
versions on the card by chip_smoke.py.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uni_adapter_tpu.ops.knn_pallas as knn_pallas
from uni_adapter_torch.ops import knn, knn_gather
from torch_threads import one_torch_thread  # noqa: F401


PAD = np.uint32(0xFFFFFFFF)
EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)


def order_key(d: np.ndarray) -> np.ndarray:
    """knn_core::order_key: fp32 → uint32 in the same order."""
    b = np.ascontiguousarray(d, dtype=np.float32).view(np.uint32)
    return b ^ np.where(b >> 31 == 1, np.uint32(0xFFFFFFFF),
                        np.uint32(0x80000000)).astype(np.uint32)


def entry(key, idx) -> np.ndarray:
    """knn_core::entry: (key, index) as one uint64, key high."""
    return (np.asarray(key, np.uint64) << np.uint64(32)) | np.asarray(
        idx, np.uint64)


def search_kth(u, ck, k, cap, hi, below):
    """knn_core::search_kth on a warp's keys u and listed keys ck (any
    shape: the warp-wide count sums them).  Returns (tied, hi, below,
    kth)."""
    ans = 0
    for bit in range(31, -1, -1):
        mid = ans | (1 << bit)
        if mid >= hi:
            continue
        n_u, n_c = int((u < mid).sum()), int((ck < mid).sum())
        assert n_u < 1 << 16 and n_c < 1 << 16     # the packed count
        if n_u + n_c < k:
            ans = mid
        else:
            hi, below = mid, n_u
            if below <= cap:
                return False, hi, below, None
    return True, hi, below, ans


def list_masked(u, j0, bound, out):
    """knn_core::mask_below + list_masked: u is (32, W), lane by
    register; j0 the lanes' first indices.  A lane's keys below `bound`
    go after those of the lanes below it (a prefix sum of the lanes'
    counts), within a lane in its mask words' order: word t % 4, then bit
    t // 4."""
    below = u < bound
    starts = len(out) + np.cumsum(below.sum(1)) - below.sum(1)
    for lane in range(32):
        assert starts[lane] == len(out)
        for t in sorted(np.flatnonzero(below[lane]), key=lambda t: (t % 4,
                                                                    t // 4)):
            out.append(entry(u[lane, t], j0[lane] + 32 * t))
    return out


def compact_equal(u, j0, key, out, limit):
    """knn_core::compact_equal: the keys equal to `key` in index order
    (register t, then lane: positions n + the set lanes below this one in
    the ballot), at most `limit` in all."""
    for t in range(u.shape[1]):
        take = u[:, t] == key
        pos = len(out) + np.cumsum(take) - take          # ballot prefix
        for lane in np.flatnonzero(take & (pos < limit)):
            assert pos[lane] == len(out)
            out.append(entry(u[lane, t], j0[lane] + 32 * t))
    return out[:limit]


def count_sorted(lst, e) -> int:
    """knn_core::count_sorted: the entries of the sorted `lst` (a power of
    2 long) below e, in log2(len) + 1 steps."""
    pos, step = 0, len(lst) // 2
    while step:
        if lst[pos + step - 1] < e:
            pos += step
        step //= 2
    return pos + int(lst[pos] < e)


def merge_candidates(lst, k, cand):
    """knn_core::merge_candidates on the list's 32 KPL slots (those from k
    on empty): a candidate goes to the listed entries below it (a binary
    search, counted in a histogram) plus the candidates below it; a listed
    entry to its position plus the candidates whose search ended at or
    before it (the histogram's prefix sum)."""
    cand = np.asarray(cand, np.uint64)
    hist = np.zeros(k + 1, np.int64)
    new = lst.copy()
    places = []
    for c in cand:
        lb = count_sorted(lst, c)
        assert lb == int((lst < c).sum())
        hist[lb] += 1
        places.append(lb + int((cand < c).sum()))
    upto = np.cumsum(hist)
    for i in range(k):
        if i + upto[i] < k:
            new[i + upto[i]] = lst[i]
    for c, r in zip(cand, places):
        if r < k:
            new[r] = c
    return new


def lanes(keys: np.ndarray, width: int) -> np.ndarray:
    """Keys of points 0.. as (32, width): point lane + 32 t at [lane, t],
    pads past the end."""
    u = np.full(32 * width, PAD)
    u[:keys.size] = keys
    return u.reshape(width, 32).T


def kpl_of(k: int) -> int:
    """The list's entries a lane, as `uat_knn_gather` picks it."""
    return next(c for c in (1, 2, 4) if k <= 32 * c)


def knn_model(k: int, d: np.ndarray) -> np.ndarray:
    """knn.cu for one query's (N,) distances: (k,) indices.  The search
    stops once at most k + 64 keys lie below its bound; each listed entry
    goes to its rank among them, the k least to the output."""
    N = d.size
    ppl = next(p for p in (1, 2, 4, 8, 16, 32, 64) if N <= 32 * p)
    u = lanes(order_key(d), ppl)
    j0, cap = np.arange(32), k + 64
    tied, hi = False, int(PAD)
    if N > cap:
        tied, hi, _, kth = search_kth(u, np.full(1, PAD), k, cap, hi, N)
    if tied:
        lst = compact_equal(u, j0, kth, list_masked(u, j0, kth, []), k)
        assert len(lst) == k
    else:
        lst = list_masked(u, j0, hi, [])
        assert k <= len(lst) <= cap
    lst = np.asarray(lst, np.uint64)
    out = np.full(k, -1, np.int64)
    for e in lst:                       # each at its rank among them
        r = int((lst < e).sum())
        if r < k:
            out[r] = int(e & np.uint64(0xFFFFFFFF))
    return out


def knn_gather_model(k: int, d: np.ndarray, tile: int,
                     stats: dict) -> np.ndarray:
    """knn_gather.cu for one query's (N,) distances, tile points a tile:
    (k,) indices.  Counts in `stats` the tiles that skipped every point,
    that listed their survivors at once, and that ran the search."""
    N, kpl = d.size, kpl_of(k)
    cap = 64 * kpl
    keys = order_key(d)
    lst = np.full(32 * kpl, EMPTY)
    for base in range(0, N, tile):
        u = lanes(keys[base:base + tile], tile // 32)
        hi = int(lst[k - 1] >> np.uint64(32))   # the carried k-th key
        below = int((u < hi).sum())
        if below == 0:
            stats["skipped"] += 1
            continue
        ck = (lst >> np.uint64(32)).astype(np.uint32)
        tied, kth = False, None
        if below > cap:                 # down to at most 32 KPL, or tied
            stats["searched"] += 1
            tied, hi, below, kth = search_kth(u, ck, k, 32 * kpl, hi, below)
        else:
            stats["listed"] += 1
        j0 = base + np.arange(32)
        cand = list_masked(u, j0, kth if tied else hi, [])
        if tied:
            cand = compact_equal(u, j0, kth, cand, cap)
        assert len(cand) <= cap
        lst = merge_candidates(lst, k, cand)
    return (lst[:k] & np.uint64(0xFFFFFFFF)).astype(np.int64)


def _cloud(kind: str, B: int, N: int, S: int, seed: int):
    """(xyz (B, N, 3), queries (B, S, 3)) float32 of one kind: `random`
    normal points and queries; `centres`, queries at cloud points (a
    query's own distance is +0); `near`, every point with a copy N/2
    later moved by 1e-5 (distances a hair below 0); `twice`, every point
    twice, N/2 apart; `equal`, one point N times; `decreasing`, distance
    from the origin falling with the index, queries near the origin."""
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    q = rng.standard_normal((B, S, 3)).astype(np.float32)
    if kind == "centres":
        q = xyz[:, rng.permutation(N)[:S]]
    elif kind in ("near", "twice"):
        half = xyz[:, :N // 2]
        copy = half if kind == "twice" else half + np.float32(1e-5) * \
            rng.standard_normal(half.shape).astype(np.float32)
        xyz = np.concatenate([half, copy], 1)
        q = xyz[:, :S]
    elif kind == "equal":
        xyz = np.broadcast_to(xyz[:, :1], (B, N, 3)).copy()
        q = xyz[:, :S]
    elif kind == "decreasing":
        dirs = xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
        xyz = (dirs * np.linspace(1.0, 0.001, N)[None, :, None]).astype(
            np.float32)
        q = (np.float32(0.002) * q).astype(np.float32)
    return np.ascontiguousarray(xyz), np.ascontiguousarray(q)


def _distances(xyz, q) -> np.ndarray:
    """(B, S, N) distances as the kernels compute them."""
    return knn.sqdist(torch.from_numpy(xyz), torch.from_numpy(q)).numpy()


def test_order_key_keeps_the_order_of_distances():
    """Sorting keys sorts distances, negatives (flipped bits) and the
    smallest subnormals included; +0 maps next above the largest
    negative, and no real key is the pad's."""
    rng = np.random.default_rng(0)
    d = np.concatenate([
        rng.standard_normal(4000).astype(np.float32) * np.float32(1e-7),
        rng.uniform(-1, 4, 4000).astype(np.float32),
        np.array([0.0, np.inf, -1e-45, 1e-45, 3.4e38, -3.4e38,
                  np.float32(1e-38)], np.float32)])
    d = np.unique(d)                    # distinct, ascending
    keys = order_key(d)
    assert (np.diff(keys.astype(np.int64)) > 0).all()
    assert keys.max() < PAD and order_key(np.float32([0.0]))[0] == 0x80000000


@pytest.mark.parametrize("kind,N,k", [
    ("random", 1, 1), ("random", 33, 33), ("random", 33, 1),
    ("random", 100, 64), ("centres", 1024, 64), ("centres", 1024, 32),
    ("near", 1024, 64), ("twice", 1024, 64), ("equal", 1024, 64),
    ("equal", 64, 64), ("decreasing", 2048, 128), ("random", 2048, 2048),
])
def test_search_and_compaction_select_the_plain_kth(kind, N, k):
    """knn.cu's arithmetic: the k-th key exactly, then the k entries below
    it and the lowest-indexed ties, each at its rank, equal to
    `knn_plain` for every query (exact)."""
    xyz, q = _cloud(kind, 2, N, 4, seed=N + k)
    d = _distances(xyz, q)
    want = knn.knn_plain(k, torch.from_numpy(xyz), torch.from_numpy(q))
    got = np.stack([np.stack([knn_model(k, d[b, s]) for s in range(4)])
                    for b in range(2)])
    np.testing.assert_array_equal(got, want.numpy())
    if kind == "near":
        assert (d < 0).any()            # the case has negative distances


@pytest.mark.parametrize("kind,N,k,tile", [
    ("random", 1, 1, 2048), ("random", 33, 33, 2048),
    ("centres", 2049, 64, 2048), ("centres", 4097, 32, 2048),
    ("centres", 4097, 128, 2048), ("random", 300, 1, 64),
    ("near", 600, 64, 128), ("near", 600, 64, 256),
    ("twice", 3000, 16, 2048), ("twice", 700, 64, 256),
    ("equal", 700, 64, 128), ("equal", 2049, 128, 2048),
    ("decreasing", 4097, 64, 2048), ("decreasing", 4097, 64, 1024),
])
def test_tiled_selection_with_pruning_matches_knn_gather_plain(
        kind, N, k, tile):
    """knn_gather.cu's arithmetic over tiles of `tile` points: pruning
    against the carried k-th key, the early-stop search, tie listing and
    the rank merges, equal to `knn_gather_plain` (indices and the exact
    gather).  On the decreasing cloud every whole tile must run the
    search (the worst case), and with FPS centres as queries some later
    tile must be listed without one."""
    xyz, q = _cloud(kind, 1, N, 8, seed=N * k + tile)
    d = _distances(xyz, q)
    vals = np.random.default_rng(N).standard_normal((1, N, 3)).astype(
        np.float32)
    want_idx, want = knn_gather.knn_gather_plain(
        k, torch.from_numpy(xyz), torch.from_numpy(q), torch.from_numpy(vals))
    stats = {"skipped": 0, "listed": 0, "searched": 0}
    idx = np.stack([knn_gather_model(k, d[0, s], tile, stats)
                    for s in range(8)])[None]
    np.testing.assert_array_equal(idx, want_idx.numpy())
    np.testing.assert_array_equal(vals[0][idx[0]][None], want.numpy())
    if kind == "decreasing":                  # every whole tile
        assert stats["searched"] == 8 * (N // tile)
    if kind == "centres" and N > tile:
        assert stats["skipped"] + stats["listed"] > 0


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX package's kNN kernels in interpret mode."""
    for name in ("knn_pallas", "knn_gather_pallas"):
        monkeypatch.setattr(knn_pallas, name, functools.partial(
            getattr(knn_pallas, name), interpret=True))


@pytest.mark.parametrize("kind,N,k", [
    ("centres", 300, 16), ("near", 256, 8), ("twice", 300, 8),
    ("equal", 200, 8), ("decreasing", 700, 16),
])
def test_model_matches_the_pallas_kernels(pallas_interpret, kind, N, k):
    """Both models against `knn_pallas` and `knn_gather_pallas` (interpret
    mode) on the hard clouds, the tiled one with tiles of 64 points so
    that every rule runs: indices exact, values bitwise."""
    xyz, q = _cloud(kind, 1, N, 6, seed=N + 7 * k)
    d = _distances(xyz, q)
    vals = np.random.default_rng(k).standard_normal((1, N, 2)).astype(
        np.float32)
    want = np.asarray(knn_pallas.knn_pallas(k, jnp.asarray(xyz),
                                            jnp.asarray(q)))
    want_g_idx, want_g = knn_pallas.knn_gather_pallas(
        k, jnp.asarray(xyz), jnp.asarray(q), jnp.asarray(vals))
    stats = {"skipped": 0, "listed": 0, "searched": 0}
    plain = np.stack([knn_model(k, d[0, s]) for s in range(6)])[None]
    tiled = np.stack([knn_gather_model(k, d[0, s], 64, stats)
                      for s in range(6)])[None]
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(tiled, np.asarray(want_g_idx))
    np.testing.assert_array_equal(vals[0][tiled[0]][None],
                                  np.asarray(want_g))
