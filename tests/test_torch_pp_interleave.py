"""The port's interleaved pipeline schedule (`parallel/pp_interleave.py`)
against the JAX package: its tables bitwise JAX's, the executor's sends
and receives paired, and the interleaved forwards, gradients, train
steps and trajectory against JAX on its CPU mesh, at the small dims of
tests/test_pp_interleave.py (Uni3D and ULIP-2 width 48, 4 heads, depth 4
or 8; OpenShape's PPTA width 48, depth 4; fp32).

The port's worlds of two, four and eight ranks are processes over gloo,
spawned once for the module (`torch_dist_worker.py`, program `pp`), and
run their cases while JAX runs its side.  Contracts, as
tests/test_pp_interleave.py states them:
  * the schedule tables equal JAX's (every field, on the six cases, the
    160-case sweep and the bubble cases), and on them each rank's plan
    computes every (chunk, microbatch) once, pairs every send with the
    next rank's receive at the same tick, and beats GPipe's bubble;
  * each stage's chunk v holds blocks (v·S + s)·Lc + c, equal to JAX's
    `stack_trunk_params_interleaved[s, v, c]`;
  * forwards within rtol/atol 1e-5 of JAX's plain forward (and of JAX's
    interleaved forward at S = 2), with PP × DP and PP × TP;
  * gradients within rtol 1e-4, atol 1e-5; two AdamW steps within the
    train-step tolerances of tests/test_torch_pp.py; the MODE-DOTA
    trajectory within 1e-4 of the replicated one, `correct` equal to it
    and to JAX's;
  * a depth that does not divide by S·V raises JAX's error text;
  * both executors on a toy affine block with per-microbatch extras
    equal plain sequential application, at S from 1 to 8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from test_torch_pp import (OPTIMIZER, OUT, PPTA, TOL, ULIP,
                           UNI3D, N, T, K, _check_train, _dota_configs,
                           _jax_train, _text, drawn_params)
from test_torch_tp import key_noise
from torch_dist_worker import collect, start_world
from uni_adapter_tpu import engine as jengine
from uni_adapter_tpu.models import ppta as jppta
from uni_adapter_tpu.models.pointbert import ULIP as JULIP
from uni_adapter_tpu.models.uni3d import Uni3D as JUni3D
from uni_adapter_tpu.parallel import pp as jpp
from uni_adapter_tpu.parallel import pp_interleave as jpi
from uni_adapter_torch import engine
from uni_adapter_torch.parallel import pp, pp_interleave as ppi
from uni_adapter_torch.weights import from_jax_params, from_jax_stacked
from torch_threads import one_torch_thread  # noqa: F401

TABLES = ("cmp_chunk", "cmp_slot", "cmp_m", "inj_m", "rcv_slot", "out_m",
          "busy")
#: forwards: name -> (world, model, inputs, S, V, n_micro, tp, dp)
FORWARDS = {
    "uni3d_2_2_8_2": (2, "u8", "pc4", 2, 2, 2, 1, 1),
    "uni3d_2_2_8_4": (2, "u8", "pc4", 2, 2, 4, 1, 1),
    "uni3d_4_2_8_4": (4, "u8", "pc4", 4, 2, 4, 1, 1),
    "uni3d_2_4_8_4": (2, "u8", "pc4", 2, 4, 4, 1, 1),
    "ulip": (2, "l8", "pts", 2, 2, 2, 1, 1),
    "openshape_False": (2, "o_False", "os", 2, 2, 2, 1, 1),
    "openshape_True": (2, "o_True", "os", 2, 2, 2, 1, 1),
    "dp": (8, "u8", "pc8", 4, 2, 2, 1, 2),
    "tp": (4, "u8", "pc4", 2, 2, 2, 2, 1),
}
#: the toy executors: (S, V, M, Lc)
TOYS = [(1, 1, 1, 1), (2, 2, 3, 1), (2, 4, 8, 1), (4, 2, 5, 2), (8, 1, 4, 1)]


def _equal_tables(S, V, M):
    got = ppi.build_interleaved_schedule(S, V, M)
    want = jpi.build_interleaved_schedule(S, V, M)
    assert (got.ticks, got.queue) == (want.ticks, want.queue), (S, V, M)
    for f in TABLES:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{f} S={S} V={V} M={M}")
    return got


def _check_plans(sched):
    """Each rank's plan: every (chunk, microbatch) once, injections on
    rank 0 in order, each send paired with the next rank's receive at the
    same tick, every queued buffer read once, the finished microbatches
    on rank S−1."""
    S, V, M = sched.n_stages, sched.interleave, sched.n_micro
    plans = [ppi.rank_plan(sched, s) for s in range(S)]
    finals = []
    for s, plan in enumerate(plans):
        done = sorted((k.chunk, k.m) for k in plan if k.m >= 0)
        assert done == sorted((v, m) for v in range(V) for m in range(M))
        inj = [k.m for k in plan if k.m >= 0 and k.src < 0]
        assert inj == (list(range(M)) if s == 0 else [])
        queued = set()
        for t, k in enumerate(plan):
            if k.m >= 0 and k.src >= 0:
                assert k.src in queued, (s, t)
                queued.discard(k.src)
            nxt = plans[(s + 1) % S][t]
            assert k.send == (nxt.recv >= 0), (s, t)
            if k.recv >= 0:
                assert k.recv not in queued, (s, t)
                queued.add(k.recv)
            if k.final:
                assert s == S - 1 and k.chunk == V - 1
                finals.append(k.m)
        assert not queued
    assert sorted(finals) == list(range(M))


@pytest.mark.parametrize("S,V,M", [
    (2, 2, 2), (2, 2, 4), (4, 2, 8), (2, 4, 8), (4, 4, 8), (3, 2, 5),
])
def test_schedule_invariants(S, V, M):
    """The tables bitwise JAX's; each rank's plan on them consistent."""
    _check_plans(_equal_tables(S, V, M))


def test_schedule_property_sweep():
    """JAX's randomised sweep over (S, V, M), the S=1 / V=1 / M=1 edges
    included: the tables bitwise JAX's everywhere, the plans consistent,
    and GPipe's tables (`gpipe_schedule`) consistent too."""
    rng = np.random.default_rng(71)
    combos = {(1, 1, 1), (1, 4, 3), (8, 1, 1), (1, 1, 7), (8, 4, 1)}
    while len(combos) < 160:
        combos.add((int(rng.integers(1, 9)), int(rng.integers(1, 5)),
                    int(rng.integers(1, 17))))
    for S, V, M in sorted(combos):
        sched = _equal_tables(S, V, M)
        _check_plans(sched)
        if S == 1:
            assert sched.ticks == V * M
        if V == 1:
            g = ppi.gpipe_schedule(S, M)
            assert g.ticks == M + S - 1
            _check_plans(g)


@pytest.mark.parametrize("S,V,M", [(4, 2, 8), (2, 4, 8), (4, 4, 16)])
def test_schedule_beats_gpipe_bubble(S, V, M):
    """The makespan in chunk ticks strictly below GPipe's V·(M+S−1) and
    within S·V of the V·M work bound."""
    sched = _equal_tables(S, V, M)
    assert V * M <= sched.ticks < sched.gpipe_chunk_ticks
    assert sched.ticks <= V * M + S * V


def _jax_models():
    z6, z3 = jnp.zeros((1, N, 6)), jnp.zeros((1, N, 3))
    out = {}
    for name, depth in (("u4", 4), ("u8", 8)):
        m = JUni3D(**UNI3D, depth=depth, dtype=jnp.float32)
        out[name] = (m, drawn_params(m, z6), "uni3d", dict(UNI3D, depth=depth))
    m = JULIP(**ULIP, depth=8, dtype=jnp.float32)
    out["l8"] = (m, drawn_params(m, z3), "ulip", dict(ULIP, depth=8))
    for rel_pe in (False, True):
        m = jppta.Projected(preset=jppta.PPTAPreset(**PPTA), out_channel=OUT,
                            rel_pe=rel_pe, dtype=jnp.float32)
        out[f"o_{rel_pe}"] = (m, drawn_params(m, z3, jnp.concatenate(
            [z3, z3], -1)), "openshape", {"preset": PPTA, "out": OUT,
                                          "rel_pe": rel_pe})
    return out


def _toy(S, V, M, Lc):
    d, Bm = 8, 2
    rng = np.random.default_rng(10_000 * S + 100 * V + 10 * M + Lc)
    W = (np.eye(d)[None] + 0.05 * rng.standard_normal((S * V * Lc, d, d))
         ).astype(np.float32)
    xs = rng.standard_normal((M, Bm, d)).astype(np.float32)
    ex = rng.standard_normal((M, Bm, d)).astype(np.float32)
    want = np.empty_like(xs)
    for m in range(M):
        h = xs[m].astype(np.float64)
        for w in W:
            h = h @ w + ex[m]
        want[m] = h
    return dict(S=S, V=V, M=M, Lc=Lc, W=W, xs=xs, ex=ex), want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's worlds of two, four and eight (spawned first), then JAX's
    references."""
    tmp = tmp_path_factory.mktemp("pp_il")
    jm = _jax_models()
    rng = np.random.default_rng(1)
    xs = {"pc8": rng.standard_normal((8, N, 6)).astype(np.float32),
          "pts": rng.standard_normal((4, N, 3)).astype(np.float32)}
    xs["pc4"] = xs["pc8"][:4]
    xyz = rng.standard_normal((4, N, 3)).astype(np.float32)
    xs["os"] = (xyz, np.concatenate([xyz, np.ones_like(xyz)], -1))
    inputs = {k: v if isinstance(v, tuple) else (v,) for k, v in xs.items()}
    ct = rng.standard_normal((4, OUT)).astype(np.float32)
    batches = [(xs["pc4"], rng.standard_normal((4, OUT)).astype(np.float32),
                rng.standard_normal((4, OUT)).astype(np.float32))
               for _ in range(2)]
    models = {k: (kind, dims, "float32", from_jax_params(p))
              for k, (_, p, kind, dims) in jm.items()}
    models["u6"] = ("uni3d", dict(UNI3D, depth=6), "float32", None)
    # tests/test_pp_interleave.py's trajectory: its init weights, data, key
    ju = jm["u4"][0]
    init = jax.jit(ju.init)(jax.random.PRNGKey(0), jnp.zeros((1, N, 6)))
    models["u4_init"] = ("uni3d", dict(UNI3D, depth=4), "float32",
                         from_jax_params(init))
    trng = np.random.default_rng(73)
    text = _text(trng, K)
    pcs = trng.standard_normal((T, 1, N, 3)).astype(np.float32)
    stream = (pcs, np.ones_like(pcs),
              trng.integers(0, K, (T, 1)).astype(np.int32))
    noise = key_noise(jax.random.PRNGKey(7), T, (1, N, 3))
    cases = [dict(name=f"fwd_{n}", type="forward", world=w, model=m,
                  inputs=inputs[x], S=S, V=V, n_micro=nm, tp=tp, dp=dp)
             for n, (w, m, x, S, V, nm, tp, dp) in FORWARDS.items()]
    toys = {c: _toy(*c) for c in TOYS}
    cases += [dict(spec, name=f"toy_{c}", type="toy", world=c[0])
              for c, (spec, _) in toys.items() if c[0] > 1]
    cases += [
        dict(name="grad", type="grad", world=2, model="u4",
             inputs=inputs["pc4"], ct=ct, S=2, V=2, n_micro=2),
        dict(name="train", type="train", world=2, model="u4", S=2, V=2,
             n_micro=2, optimizer=OPTIMIZER, batches=batches),
        dict(name="blocks", type="blocks", world=2, model="u8", S=2, V=2),
        dict(name="err_depth", type="error", world=2, model="u6", S=2, V=2,
             inputs=inputs["pc4"]),
        dict(name="traj", type="trajectory", world=2, model="u4_init",
             kind="uni3d", S=2, V=2, cfg=_dota_configs("uni3d")[1],
             text=text, stream=stream, noise=noise, replicated=True)]
    procs = {w: start_world("pp", {"models": models, "cases": cases},
                            tmp / f"w{w}", world=w) for w in (2, 4, 8)}

    want = {"toys": toys}
    for name in ("u8", "l8", "o_False", "o_True"):
        m, params = jm[name][:2]
        x = inputs[{"u": "pc8", "l": "pts", "o": "os"}[name[0]]]
        want[name] = np.asarray(jax.jit(m.apply)(
            params, *(jnp.asarray(a) for a in x)))
    m, params = jm["u4"][:2]
    pc4 = jnp.asarray(xs["pc4"])
    want["grad"] = from_jax_params(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(lambda p: jnp.sum(
            m.apply(p, pc4) * ct)))(params)))
    want["train"] = _jax_train(m, params, batches, 1)
    jc = _dota_configs("uni3d")[0]
    _, outs = jax.jit(jengine.make_scan_fn(jc, ju))(
        init, jnp.asarray(text), jengine.init_state(
            jc, jnp.asarray(text), jax.random.PRNGKey(7)),
        *(jnp.asarray(a) for a in stream))
    want["traj"] = (np.asarray(outs.final_logits), np.asarray(outs.correct))
    m8, p8 = jm["u8"][:2]
    want["stacked"] = from_jax_stacked(
        jpi.stack_trunk_params_interleaved(p8["params"]["point_encoder"], 8,
                                           2, 2),
        "point_encoder.blocks", interleaved=True)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("stage",))
    prepare, fwd = jpp.make_pp_forward_uni3d(m8, mesh, n_micro=2,
                                             interleave=2)
    want["jax_pp"] = np.asarray(fwd(prepare(p8), jnp.asarray(xs["pc4"])))
    m6 = JUni3D(**UNI3D, depth=6, dtype=jnp.float32)
    try:
        jpp.make_pp_forward_uni3d(m6, mesh, interleave=2)[0](
            drawn_params(m6, jnp.zeros((1, N, 6))))
    except ValueError as e:
        want["err_depth"] = str(e)
    # the one-stage toy runs here, without a process group
    spec = toys[(1, 1, 1, 1)][0]
    want["toy_local"] = _toy_here(spec)
    got = {w: collect(p, tmp / f"w{w}", timeout=300.0)
           for w, p in procs.items()}
    return want, got


def _toy_here(spec):
    import torch

    W, xs, ex = (torch.from_numpy(spec[k]) for k in ("W", "xs", "ex"))

    def chunk(x, e):
        for w in W:
            x = x @ w + e
        return x
        yield
    stages = pp.make_stages(1)
    outs = engine.drive(pp._pipeline([chunk], xs, stages.ring, ex), None)
    return pp._stacked(outs, xs).numpy()


def _ok(result):
    assert not (isinstance(result, dict) and "error" in result), \
        result.get("error")
    return result


def test_interleaved_stacking_order(runs):
    """Stage s's chunk v holds block (v·S + s)·Lc + c under its global
    name, equal to JAX's stacked[s, v, c]."""
    want, got = runs
    for s in range(2):
        res = _ok(got[2][s]["blocks"])
        held = {n for n in res["params"] if ".blocks." in n}
        assert {int(n.split(".")[2]) for n in held} == {
            (v * 2 + s) * 2 + c for v in range(2) for c in range(2)}
        for n in held:
            np.testing.assert_array_equal(res["params"][n],
                                          want["stacked"][n].numpy())


def test_interleaved_rejects_indivisible_depth(runs):
    """Six blocks over 2 stages × 2 chunks: JAX's ValueError text."""
    want, got = runs
    assert "not divisible" in want["err_depth"]
    for r in range(2):
        assert got[2][r]["err_depth"] == want["err_depth"]


def _forward(runs, name):
    want, got = runs
    w = FORWARDS[name][0]
    return [_ok(got[w][r][f"fwd_{name}"]) for r in range(w)], want


@pytest.mark.parametrize("name", ["uni3d_2_2_8_2", "uni3d_2_2_8_4",
                                  "uni3d_4_2_8_4", "uni3d_2_4_8_4"])
def test_interleaved_uni3d_matches_plain_forward(runs, name):
    res, want = _forward(runs, name)
    for r in res:
        np.testing.assert_allclose(r["feat"], want["u8"][:4], rtol=TOL,
                                   atol=TOL)


def test_port_matches_jax_interleaved_forward(runs):
    """The port's interleaved forward (S = 2, V = 2) within 1e-5 of JAX's
    `make_pp_forward_uni3d(interleave=2)`."""
    res, want = _forward(runs, "uni3d_2_2_8_2")
    for r in res:
        np.testing.assert_allclose(r["feat"], want["jax_pp"], rtol=TOL,
                                   atol=TOL)


def test_interleaved_ulip_matches_plain_forward(runs):
    """The positions re-taken by the schedule's microbatch, never rotated:
    each shift one (2, 17, 48) buffer."""
    res, want = _forward(runs, "ulip")
    for r in res:
        np.testing.assert_allclose(r["feat"], want["l8"], rtol=TOL, atol=TOL)
        for kind, b, shape in r["log"]:
            if kind == "shift" and shape is not None:
                assert shape == (2, 17, 48)


@pytest.mark.parametrize("rel_pe", [False, True])
def test_interleaved_openshape_matches_plain_forward(runs, rel_pe):
    res, want = _forward(runs, f"openshape_{rel_pe}")
    for r in res:
        np.testing.assert_allclose(r["feat"], want[f"o_{rel_pe}"], rtol=TOL,
                                   atol=TOL)


def test_interleaved_dp_composition_matches_plain_forward(runs):
    """Interleaved PP × DP on a 4 × 2 (stage, data) grid."""
    res, want = _forward(runs, "dp")
    for r in res:
        np.testing.assert_allclose(r["feat"], want["u8"], rtol=TOL, atol=TOL)


def test_interleaved_tp_composition_matches_plain_forward(runs):
    """Interleaved PP × TP on a 2 × 2 (stage, model) grid: each chunk's
    blocks Megatron-sharded over the model pair."""
    res, want = _forward(runs, "tp")
    for r in res:
        np.testing.assert_allclose(r["feat"], want["u8"][:4], rtol=TOL,
                                   atol=TOL)
        assert "sum" in [k for k, *_ in r["log"]]


def test_interleaved_grad_matches_plain_forward(runs):
    """Gradients through the interleaved schedule (its ticks in reverse,
    the reverse shifts) within rtol 1e-4, atol 1e-5 of JAX's plain
    forward's."""
    want, got = runs
    seen = set()
    for r in range(2):
        grads = _ok(got[2][r]["grad"])["grads"]
        for n, g in grads.items():
            np.testing.assert_allclose(g, want["grad"][n].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=n)
        seen |= set(grads)
    assert seen == set(want["grad"])


def test_interleaved_train_step_matches_single_device(runs):
    """Two AdamW steps through the interleaved schedule against JAX's
    single-device steps (the tolerances of tests/test_torch_pp.py)."""
    want, got = runs
    jmetrics, jparams, jls = want["train"]
    _check_train([_ok(got[2][r]["train"]) for r in range(2)], jmetrics,
                 {n: t.numpy() for n, t in jparams.items()}, jls)


def test_interleaved_engine_step_trajectory_matches(runs):
    """The MODE-DOTA scan with residuals on the interleaved PP encoder, on
    tests/test_pp_interleave.py's init weights, data and key (JAX's noise
    fed): every step's logits within 1e-4 of the replicated trajectory
    (as JAX's test holds its pipeline to its replicated run: here the
    port's, one process), `correct` equal to it and to JAX's replicated
    run.  (The port's replicated run itself drifts from JAX's by up to
    1.2e-2 in 100·cosine by the fourth step of this stream; the engine's
    own tests hold it within 1e-3 over two.)"""
    want, got = runs
    _, correct = want["traj"]
    for r in range(2):
        res = _ok(got[2][r]["traj"])
        np.testing.assert_allclose(res["final_logits"], res["replicated"],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(res["correct"],
                                      res["replicated_correct"])
        np.testing.assert_array_equal(res["correct"], correct)


@pytest.mark.parametrize("S,V,M,Lc", TOYS)
def test_toy_executor_equality_with_extras(runs, S, V, M, Lc):
    """Both executors on y = x·W_l + e_m equal plain sequential
    application within 1e-5, on every rank: M not a multiple of S, M
    below S·V, V = 1 on eight stages, two-block chunks, one stage."""
    want, got = runs
    spec, truth = want["toys"][(S, V, M, Lc)]
    if S == 1:
        np.testing.assert_allclose(want["toy_local"], truth, rtol=1e-5,
                                   atol=1e-5)
        return
    for r in range(S):
        res = _ok(got[S][r][f"toy_{(S, V, M, Lc)}"])
        np.testing.assert_allclose(res["out"], truth, rtol=1e-5, atol=1e-5)
        assert res["n_shifts"] > 0
