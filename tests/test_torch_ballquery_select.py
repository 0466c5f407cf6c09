"""The selection of the ball-query kernel (`csrc/ballquery.cu`), modelled
in numpy lane by lane and held exactly against the plain version
(`query_ball_plain`) and the JAX package's Pallas kernel in interpret
mode (`query_ball_pallas`).

The model follows the kernel step for step: a block of `queries` queries
streams the cloud in tiles of `tile` points (past the cloud's end NaN,
which no ball holds); each query's `group` warps walk a tile in rounds,
warp g the g-th contiguous run of `chunks` 32-point chunks, a 32-bit vote
a chunk; each warp posts its run's in-ball count and first in-ball index,
and after the round's barrier an in-ball lane takes slot count + the
counts of the runs before its own + popc(votes of the lower lanes); the
query's first in-ball index is the least of its runs' firsts in the first
round that has one.  A query stops after the round in which nsample are
found; the block stops after a round in which no query was open, and
streams no further tile once all its queries are full.  Unfilled slots
take the first in-ball index, an empty ball N - 1.  The CUDA kernel is
held to the plain version on the card by chip_smoke.py.
"""
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uni_adapter_tpu.ops.ballquery_pallas as ballquery_pallas
from uni_adapter_torch.ops import ballquery, knn
from torch_threads import one_torch_thread  # noqa: F401


SOURCE = (Path(ballquery.__file__).resolve().parent.parent / "csrc"
          / "ballquery.cu")
#: Small configurations, so that the tests cross many tile and run edges:
#: (queries a block, warps a query, chunks a warp a round, tile).
SMALL = (2, 2, 2, 256)
ONE_WARP = (3, 1, 4, 256)


def source_config() -> tuple:
    """(queries a block, warps a query, chunks a warp a round, tile) as
    `csrc/ballquery.cu` defines UAT_BALLQUERY_CONFIG."""
    m = re.search(r"#define UAT_BALLQUERY_CONFIG ([\d, ]+)\n",
                  SOURCE.read_text())
    return tuple(int(v) for v in m.group(1).split(","))


def votes(inside: np.ndarray) -> list:
    """__ballot_sync of each 32-lane chunk of the (32 c,) bools: lane l at
    bit l."""
    return [int(sum(1 << lane for lane in np.flatnonzero(chunk)))
            for chunk in inside.reshape(-1, 32)]


def popc(v: int) -> int:
    return bin(v).count("1")


def ffs(v: int) -> int:
    """__ffs: 1 + the lowest set bit, 0 for 0."""
    return (v & -v).bit_length()


def block_model(d: np.ndarray, r2: np.float32, nsample: int, config: tuple,
                stats: dict) -> np.ndarray:
    """ballquery_kernel for one block's queries: d is (Q, N) float32
    distances (Q ≤ the block's queries), returns (Q, nsample) int64.
    Counts in `stats` the tiles staged and the rounds walked."""
    queries, group, chunks, tile = config
    run, rnd = 32 * chunks, 32 * chunks * group
    Q, N = d.shape
    assert Q <= queries and tile % rnd == 0
    out = np.full((Q, nsample), -1, np.int64)
    count, first = [0] * Q, [-1] * Q
    more = True
    for base in range(0, N, tile):
        if not more or (base > 0 and all(c >= nsample for c in count)):
            break                                   # __syncthreads_or
        stats["tiles"] += 1
        n = min(tile, N - base)
        dt = np.full((Q, tile), np.nan, np.float32)
        dt[:, :n] = d[:, base:base + n]
        for t0 in range(0, n, rnd):
            if not more:
                break
            stats["rounds"] += 1
            opened = [c < nsample for c in count]
            more = any(opened)                      # __syncthreads_or
            for q in np.flatnonzero(opened):
                runs = []                           # (votes, r0) by g
                for g in range(group):
                    r0 = t0 + run * g
                    runs.append((votes(dt[q, r0:r0 + run] <= r2), r0))
                posts = [(sum(map(popc, v)), min(
                    (r0 + 32 * c + ffs(x) - 1 for c, x in enumerate(v) if x),
                    default=None)) for v, r0 in runs]
                for g, (v, r0) in enumerate(runs):
                    slot0 = count[q] + sum(k for k, _ in posts[:g])
                    for c, x in enumerate(v):
                        for lane in range(32):
                            if x >> lane & 1:
                                slot = slot0 + popc(x & ((1 << lane) - 1))
                                if slot < nsample:
                                    assert out[q, slot] == -1
                                    out[q, slot] = base + r0 + 32 * c + lane
                        slot0 += popc(x)
                firsts = [f for _, f in posts if f is not None]
                if first[q] < 0 and firsts:
                    first[q] = base + min(firsts)
                count[q] += sum(k for k, _ in posts)
    for q in range(Q):
        fill = N - 1 if first[q] < 0 else first[q]
        out[q, min(count[q], nsample):] = fill
    assert (out >= 0).all()
    return out


def kernel_model(radius: float, nsample: int, xyz: np.ndarray,
                 q: np.ndarray, config: tuple, stats: dict) -> np.ndarray:
    """The launch: (B, S, nsample) from blocks of config[0] queries."""
    d = knn.sqdist(torch.from_numpy(xyz), torch.from_numpy(q)).numpy()
    r2 = np.float32(ballquery.squared_radius(radius))
    B, S, _ = d.shape
    per = config[0]
    return np.stack([np.concatenate([
        block_model(d[b, s:s + per], r2, nsample, config, stats)
        for s in range(0, S, per)]) for b in range(B)])


def sphere(rng, B, N) -> np.ndarray:
    """(B, N, 3) points on a sphere of radius 0.5, as the streams hold."""
    x = rng.standard_normal((B, N, 3))
    return (0.5 * x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(
        np.float32)


def make_case(kind: str, N: int, S: int, seed: int):
    """(xyz (B, N, 3), queries (B, S, 3), radius) float32 of one kind:
    `sphere`, points on a sphere of radius 0.5 with S of them as the
    queries, r 0.2 (OpenShape's clouds and centres); `inside`, every point
    in every ball; `boundary`, many points at exactly d = r² from the
    first query (the origin; on the axes) and the rest just outside;
    `twice`, every point twice, N/2 apart; `mixed`, in each block of
    four queries a full, a partial and an empty ball, and a full one
    centred on a cloud point."""
    rng = np.random.default_rng(seed)
    if kind in ("sphere", "twice"):
        xyz = sphere(rng, 2, N)
        if kind == "twice":
            xyz = np.concatenate([xyz[:, :N // 2]] * 2 + [xyz[:, :N % 2]], 1)
        return xyz, xyz[:, rng.permutation(N)[:S]], 0.2
    if kind == "inside":
        return sphere(rng, 2, N), sphere(rng, 2, S), 2.0
    if kind == "boundary":
        x = np.float32(0.25)
        axis = rng.integers(0, 3, (1, N))
        sign = rng.choice([-1.0, 1.0], (1, N)).astype(np.float32)
        out = rng.random((1, N)) < 0.5        # moved one ulp outwards
        mag = np.where(out, np.nextafter(x, np.float32(1)), x)
        xyz = np.zeros((1, N, 3), np.float32)
        np.put_along_axis(xyz, axis[..., None], (sign * mag)[..., None], 2)
        q = np.concatenate([np.zeros((1, 1, 3), np.float32),
                            sphere(rng, 1, S - 1)], 1)
        return xyz, q, float(x)
    assert kind == "mixed"
    dense = (0.05 * sphere(rng, 1, N // 2)).astype(np.float32)
    sparse = sphere(rng, 1, N - N // 2) + np.float32(1.0)
    xyz = np.concatenate([sparse[:, :N // 4], dense,
                          sparse[:, N // 4:]], 1).astype(np.float32)
    per_block = np.array([[0.0, 0.0, 0.0], [1.75, 1.0, 1.0],
                          [9.0, 9.0, 9.0], [0.0, 0.0, 0.0]], np.float32)
    q = np.tile(per_block, (S // 4, 1))[None]
    q[0, 3::4] = xyz[0, N // 4]               # a dense point: ties at 0
    return xyz, q, 0.3


def plain(radius, nsample, xyz, q) -> np.ndarray:
    return ballquery.query_ball_plain(radius, nsample, torch.from_numpy(xyz),
                                      torch.from_numpy(q)).numpy()


def test_config_is_the_sources():
    """The model runs the configuration the source ships: more than one
    32-point chunk a dependent step, a tile a multiple of the round."""
    queries, group, chunks, tile = source_config()
    assert queries >= 1 and group * chunks >= 2
    assert tile % (32 * chunks * group) == 0


@pytest.mark.parametrize("kind,N,S,nsample,config", [
    ("sphere", 1, 1, 1, "source"),
    ("sphere", 31, 5, 31, "source"),
    ("sphere", 33, 9, 33, "source"),          # nsample = N
    ("sphere", 33, 8, 1, SMALL),
    ("sphere", 1023, 16, 64, "source"),       # N not a multiple of 4
    ("sphere", 255, 8, 64, SMALL),            # a tile edge - 1, + 0, + 1
    ("sphere", 256, 8, 64, SMALL),
    ("sphere", 257, 8, 64, SMALL),
    ("inside", 300, 6, 300, SMALL),           # every point in every ball
    ("inside", 300, 6, 64, SMALL),
    ("boundary", 700, 8, 200, SMALL),         # d = r² exactly
    ("twice", 1025, 8, 64, SMALL),            # duplicated points
    ("mixed", 1200, 16, 64, SMALL),           # full, partial, empty
    ("mixed", 1200, 16, 64, "source"),
    ("mixed", 1200, 12, 64, ONE_WARP),
    ("twice", 600, 9, 16, ONE_WARP),
])
def test_model_equals_query_ball_plain(kind, N, S, nsample, config):
    """The kernel's selection equals `query_ball_plain` in every slot."""
    config = source_config() if config == "source" else config
    xyz, q, r = make_case(kind, N, S, seed=N * S + nsample)
    stats = {"tiles": 0, "rounds": 0}
    got = kernel_model(r, nsample, xyz, q, config, stats)
    want = plain(r, nsample, xyz, q)
    np.testing.assert_array_equal(got, want)
    d = knn.sqdist(torch.from_numpy(xyz), torch.from_numpy(q)).numpy()
    hits = (d <= np.float32(ballquery.squared_radius(r))).sum(-1)
    if kind == "inside":
        assert (hits == N).all()
    if kind == "boundary":
        at = d[0, 0] == np.float32(ballquery.squared_radius(r))
        assert at.sum() > N // 4 and (hits[0, 0] == at.sum())
        np.testing.assert_array_equal(got[0, 0, :at.sum()],
                                      np.flatnonzero(at)[:nsample])
    if kind == "mixed":
        assert (hits[0, 0::4] >= nsample).all()
        assert ((hits[0, 1::4] > 0) & (hits[0, 1::4] < nsample)).all()
        assert (hits[0, 2::4] == 0).all() and (got[0, 2::4] == N - 1).all()


def test_tiles_stop_once_every_ball_is_full():
    """On OpenShape's 10,000-point clouds every ball fills within the
    first tiles: the blocks stage far fewer tiles than the cloud holds,
    and the 20,000-point cloud (past one tile at any configuration) gives
    the plain version's indices too."""
    rng = np.random.default_rng(0)
    for N, config in ((10000, source_config()), (20000, (4, 4, 4, 1024))):
        xyz = sphere(rng, 1, N)
        q = xyz[:, rng.permutation(N)[:16]]
        stats = {"tiles": 0, "rounds": 0}
        got = kernel_model(0.2, 64, xyz, q, config, stats)
        np.testing.assert_array_equal(got, plain(0.2, 64, xyz, q))
        blocks = 16 // config[0]
        assert stats["tiles"] < blocks * (-(-N // config[3])) / 2


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX package's ball-query kernel in interpret mode."""
    monkeypatch.setattr(ballquery_pallas, "query_ball_pallas",
                        functools.partial(ballquery_pallas.query_ball_pallas,
                                          interpret=True))


@pytest.mark.parametrize("kind,N,S,nsample", [
    ("sphere", 33, 8, 33), ("boundary", 300, 8, 32), ("twice", 300, 8, 16),
    ("mixed", 520, 8, 32), ("inside", 64, 4, 64),
])
def test_model_matches_the_pallas_kernel(pallas_interpret, kind, N, S,
                                         nsample):
    """The model, at the source's configuration and the small ones,
    against `query_ball_pallas` (interpret mode): exact."""
    xyz, q, r = make_case(kind, N, S, seed=N + nsample)
    want = np.asarray(ballquery_pallas.query_ball_pallas(
        r, nsample, jnp.asarray(xyz), jnp.asarray(q)))
    for config in (source_config(), SMALL, ONE_WARP):
        stats = {"tiles": 0, "rounds": 0}
        np.testing.assert_array_equal(
            kernel_model(r, nsample, xyz, q, config, stats), want)
