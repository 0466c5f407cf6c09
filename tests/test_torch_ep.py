"""The port's class-sharded MODE-DOTA (`parallel/ep.py`, `--dist-mode ep`)
over a torch.distributed world against the JAX package's `parallel/ep.py`
on a CPU mesh of the same size, at the small dims of tests/test_ep.py
(Uni3D depth 1, width 48, D 32, N 48, fp32).

The port's worlds (two ranks; four for DP × EP on a 2 × 2 grid) are
processes over gloo, spawned once for the module
(`torch_dist_worker.py`), which run every case and hand back their
results while JAX runs its side.  The port's step is handed JAX's noise
(the replicated key's draws).

Two contracts, as tests/test_ep.py's EP-against-replicated one reads
when the encoders are two packages': the port's EP run against the
port's replicated run (`engine.run_stream_scan`, rank 0) at
tests/test_ep.py's tolerances (the state within rtol 1e-5, atol 1e-7
with residuals off; with residuals on, whose exp(exp(·)) loss amplifies
rounding, the residuals within atol 1e-2 and the means within rtol 1e-3,
atol 1e-4; one Adam step of the sharded residual loop within atol 1e-5
of JAX's replicated one), and against JAX's EP run: the summaries equal
and the state within CROSS of its largest entry (the port's fp32
encoder is not JAX's bit for bit; tests/test_torch_variants.py's bound
on a stream's state).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist_worker import collect, start_world
from uni_adapter_tpu import config as jcfg
from uni_adapter_tpu import engine as jengine
from uni_adapter_tpu.adapt import mode_dota as jmode_dota
from uni_adapter_tpu.adapt import residual as jresidual
from uni_adapter_tpu.cli import tta as jtta
from uni_adapter_tpu.models.uni3d import create_uni3d as jax_create_uni3d
from uni_adapter_tpu.parallel import ep as jep
from uni_adapter_torch import config as pcfg
from uni_adapter_torch import engine
from uni_adapter_torch.parallel import ep
from uni_adapter_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

D, N, T = 32, 48, 6
SMALL = dict(pc_feat_dim=48, embed_dim=D, num_group=8, group_size=8,
             pc_encoder_dim=24, eva_depth=1, eva_heads=4,
             compute_dtype="float32")
CLI_CORRUPTIONS = ["uniform", "gaussian"]
CROSS = 1e-4
CLI_ARGS = ["--npoints", "64", "--eva-depth", "1", "--pc-feat-dim", "48",
            "--embed-dim", "32", "--num-group", "8", "--group-size", "8",
            "--pc-encoder-dim", "24", "--eva-heads", "4",
            "--compute-dtype", "float32", "--corruption", "all",
            "--dota-res-learning", "false", "--dist-mode", "ep",
            "--name", "run", "--device", "cpu"]


def configs(**dota):
    kw = dict(use_dota=False, use_mode_dota=True, mode_M=2,
              res_learning=False, residual_steps=2)
    kw.update(dota)
    return (jcfg.Config(model=jcfg.ModelConfig(**SMALL),
                        dota=jcfg.DotaConfig(**kw)),
            pcfg.Config(model=pcfg.ModelConfig(**SMALL),
                        dota=pcfg.DotaConfig(**kw)))


def text_of(rng, K):
    t = rng.standard_normal((K, D)).astype(np.float32)
    return t / np.linalg.norm(t, axis=1, keepdims=True)


def stream_of(rng, K, B, steps=T):
    pcs = rng.standard_normal((steps, B, N, 3)).astype(np.float32)
    return pcs, np.ones_like(pcs), rng.integers(0, K, (steps, B)).astype(
        np.int32)


def key_noise(key, n_steps, shape):
    """The noise MODE-DOTA's step draws from the carried key, n_steps
    steps (split, normal from the second half)."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


#: name: (data seed, K, B, dota overrides, shard_encoder, two halves)
CASES = {"state_K6": (1, 6, 2, {}, False, False),
         "state_K5": (2, 5, 2, {}, False, False),
         "res_K5": (3, 5, 1, dict(res_learning=True), False, False),
         "k_small": (4, 1, 1, dict(mode_M=1, res_learning=True,
                                   residual_steps=1), False, False),
         "se_B1": (5, 6, 1, {}, True, False),
         "plain_B1": (5, 6, 1, {}, False, False),
         "se_B2": (6, 6, 2, {}, True, False),
         "plain_B2": (6, 6, 2, {}, False, False),
         "continual": (7, 5, 1, {}, False, True)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's worlds of two and four (spawned first), then JAX's runs
    on 2- and (2, 2)-device meshes."""
    tmp = tmp_path_factory.mktemp("ep")
    jmodel = jax_create_uni3d(jcfg.ModelConfig(**SMALL))
    rng = np.random.default_rng(0)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, N, 6), jnp.float32))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
        .astype(np.float32), params)
    base = {"model_cfg": pcfg.ModelConfig(**SMALL),
            "state_dict": from_jax_params(params)}

    cases, jax_cases = {}, {}
    for name, (seed, K, B, dota, se, split) in CASES.items():
        jc, pc = configs(**dota)
        crng = np.random.default_rng(seed)
        text = text_of(crng, K)
        pcs, rgbs, tgts = stream_of(crng, K, B)
        noise = key_noise(jax.random.PRNGKey(42), T, (B, N, 3))
        bounds = [(0, T // 2), (T // 2, T)] if split else [(0, T)]
        cases[name] = {"cfg": pc, "text": text, "runs": [
            (pcs[a:b], rgbs[a:b], tgts[a:b], noise[a:b], se)
            for a, b in bounds]}
        jax_cases[name] = (jc, text, (pcs, rgbs, tgts), se, bounds)

    # one Adam step of the sharded residual loop (tests/test_ep.py's
    # parity check): K 5 pads to 6 over two ranks
    K, M = 5, 2
    gtext = text_of(rng, K)
    st = jmode_dota.init(1e-3, 0.05, D, K, jnp.asarray(gtext.T), num_modes=M)
    st = st._replace(
        mu=st.mu + 0.01 * rng.standard_normal(st.mu.shape).astype(np.float32),
        c=jnp.asarray(rng.uniform(0.5, 2.0, st.c.shape).astype(np.float32)))
    res0 = 0.001 * rng.standard_normal((K, D)).astype(np.float32)

    def pad(a, fill=0.0):
        a = np.asarray(a)
        return np.concatenate([a, np.full((1,) + a.shape[1:], fill,
                                          np.float32)])

    text_p = pad(gtext)
    text_p[K:, 0] = 1.0
    grad = {"K": K, "M": M, "padded": {
        "text": text_p, "mu": pad(st.mu), "var": pad(st.var, 0.05),
        "pi": pad(st.pi, 1.0 / M), "c": pad(st.c, 1.0 / M),
        "cc": pad(st.class_counts), "res": pad(res0)}}

    # DP × EP: 4 streams over a 2 × 2 grid, K 6
    Kd, C = 6, 4
    dtext = text_of(rng, Kd)
    spcs = rng.standard_normal((C, T, 1, N, 3)).astype(np.float32)
    streams = (spcs, np.ones_like(spcs),
               rng.integers(0, Kd, (C, T, 1)).astype(np.int32))
    jdp, pdp = configs()
    snoise = [key_noise(jax.random.PRNGKey(42 + i), T, (1, N, 3))
              for i in range(C)]
    dp_ep = {"cfg": pdp, "text": dtext, "streams": streams,
             "noise": [np.stack(snoise[2 * d:2 * d + 2], axis=1)
                       for d in range(2)]}

    # the CLI over two corruptions, 4 clouds each, a seeded (40, D) bank
    root = tmp / "data"
    root.mkdir()
    for corr in CLI_CORRUPTIONS:
        np.save(root / f"data_{corr}_5.npy",
                rng.standard_normal((4, 64, 3)).astype(np.float32))
    np.save(root / "label.npy", rng.integers(0, 40, (4,)).astype(np.int64))
    np.save(tmp / "bank.npy", text_of(rng, 40))
    cli = {name: [*CLI_ARGS, "--root", str(root),
                  "--precomputed-text-features", str(tmp / "bank.npy"),
                  *flags,
                  "--output-dir", str(tmp / f"port_{name}")]
           for name, flags in (("continual", ["--continual", "true"]),
                               ("vmap", ["--vmap-corruptions", "true"]))}

    procs = start_world("ep", {**base, "cases": cases, "grad": grad,
                               "cli": cli, "cli_corruptions": CLI_CORRUPTIONS},
                        tmp / "w2")
    procs4 = start_world("ep", {**base, "dp_ep": dp_ep}, tmp / "w4", world=4)

    mesh = jep.make_classes_mesh(2)
    want = {}
    for name, (jc, text, (pcs, rgbs, tgts), se, bounds) in jax_cases.items():
        carry, parts = None, []
        for a, b in bounds:
            carry, summary = jep.run_stream_ep(
                jc, jmodel, params, text, pcs[a:b], rgbs[a:b], tgts[a:b],
                mesh=mesh, seed=42, initial_state=carry, shard_encoder=se)
            parts.append((carry, summary))
        want[name] = parts
    opt = jresidual.make_optimizer(1e-3)
    rs = jresidual.ResidualState(jnp.asarray(res0),
                                 opt.init(jnp.asarray(res0)))
    want["grad"] = (np.asarray(jresidual.optimize_residuals(
        rs, jnp.asarray(gtext), st, opt, 1e-3, num_steps=1).residuals),
        grad["padded"]["res"])
    grid = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                             ("data", "classes"))
    want["dp_ep"] = jep.run_streams_ep(jdp, jmodel, params, dtext, *streams,
                                       mesh=grid, seed=42)
    # the JAX CLI on the same weights and corruptions, its classes over a
    # 2-device mesh (the vmapped sweep's over all 8)
    jbuild, jcorr, jmesh = jtta.build_model, jtta.CORRUPTIONS, \
        jep.make_classes_mesh
    jtta.build_model = lambda cfg: (jmodel, params)
    jtta.CORRUPTIONS = CLI_CORRUPTIONS
    jep.make_classes_mesh = lambda n=None, axis="classes": jmesh(2, axis)
    try:
        for name in cli:
            argv = [a if a != str(tmp / f"port_{name}") else
                    str(tmp / f"jax_{name}") for a in cli[name]]
            want[f"cli_{name}"] = jtta.main(argv)
    finally:
        jtta.build_model, jtta.CORRUPTIONS = jbuild, jcorr
        jep.make_classes_mesh = jmesh
    got = collect(procs, tmp / "w2", timeout=300.0)
    got4 = collect(procs4, tmp / "w4", timeout=300.0)
    return want, got, got4, tmp


def _ok(result):
    assert "error" not in result, result.get("error")
    return result


def assert_mixture_close(got: dict, want: dict, rtol=1e-5, atol=1e-7,
                         names=("mu", "var", "pi", "c", "class_counts")):
    """The port's EP state against the port's replicated one."""
    for name in names:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, err_msg=name)


def assert_near_jax(got: dict, jstate, names=("mu", "var", "pi", "c",
                                              "class_counts")):
    """The port's EP state against JAX's EP state, within CROSS of the
    largest entry."""
    for name in names:
        want = np.asarray(getattr(jstate.method_state, name))
        np.testing.assert_allclose(got[name], want, rtol=0,
                                   atol=CROSS * np.abs(want).max(),
                                   err_msg=name)


def summaries_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        assert got[key] == pytest.approx(float(want[key]), abs=1e-5), key


@pytest.mark.parametrize("name", ["state_K6", "state_K5"])
def test_ep_state_matches_jax(runs, name):
    """Residuals off, divisible (6) and padded (5 → 6) class counts: both
    ranks hold the replicated run's full-K state, near JAX's EP state,
    and JAX's summary."""
    want, got, _, _ = runs
    (jstate, jsummary), = want[name]
    replicated = _ok(got[0][name])[0]["replicated"]
    for rank in range(2):
        res = _ok(got[rank][name])[0]
        assert_mixture_close(res["state"], replicated)
        assert_near_jax(res["state"], jstate)
        assert res["state"]["t"] == int(jstate.method_state.t)
        assert res["state"]["step"] == int(jstate.step) == T
        summaries_equal(res["summary"], jsummary)
    assert got[0][name][0]["summary"]["padded_classes"] == (
        1 if name == "state_K5" else 0)


def test_ep_residual_learning_within_the_envelope(runs):
    """Residuals on, K 5 over 2 ranks: the residuals within atol 1e-2 and
    the means within rtol 1e-3 of the replicated run's and of JAX's EP
    run's, acc@1 equal to JAX's; the returned
    state is cut back to K (the pad row stripped) and the real classes
    took 2T fits of probability mass."""
    want, got, _, _ = runs
    (jstate, jsummary), = want["res_K5"]
    res = _ok(got[0]["res_K5"])[0]
    for ref in (res["replicated"], {
            "res.residuals": np.asarray(jstate.res_state.residuals),
            "mu": np.asarray(jstate.method_state.mu)}):
        np.testing.assert_allclose(res["state"]["res.residuals"],
                                   ref["res.residuals"], atol=1e-2)
        np.testing.assert_allclose(res["state"]["mu"], ref["mu"],
                                   rtol=1e-3, atol=1e-4)
    assert res["summary"]["acc1"] == pytest.approx(jsummary["acc1"])
    assert res["state"]["mu"].shape[0] == 5
    assert res["state"]["res.residuals"].shape == (5, D)
    assert res["state"]["class_counts"].sum() == pytest.approx(2 * T,
                                                               rel=1e-5)


def test_ep_residual_one_step_gradient_parity(runs):
    """One Adam step of `optimize_residuals_sharded` over two ranks equals
    JAX's replicated `optimize_residuals` within atol 1e-5, and the pad
    row's residual does not move."""
    want, got, _, _ = runs
    full, res0 = want["grad"]
    blocks = np.concatenate([_ok({"r": got[r]["grad_parity"]})["r"]
                             for r in range(2)])
    np.testing.assert_allclose(blocks[:5], full, atol=1e-5)
    np.testing.assert_array_equal(blocks[5:], res0[5:])


def test_ep_k_smaller_than_the_world(runs):
    """K 1 over two ranks (rank 1 holds only a pad class), M 1, residuals
    on: the means within rtol 1e-3 of the replicated run's and JAX's,
    acc@1 equal, the residuals finite."""
    want, got, _, _ = runs
    (jstate, jsummary), = want["k_small"]
    replicated = _ok(got[0]["k_small"])[0]["replicated"]
    for rank in range(2):
        res = _ok(got[rank]["k_small"])[0]
        for ref in (replicated["mu"], np.asarray(jstate.method_state.mu)):
            np.testing.assert_allclose(res["state"]["mu"], ref, rtol=1e-3,
                                       atol=1e-5)
        assert res["summary"]["acc1"] == pytest.approx(jsummary["acc1"])
        assert res["summary"]["padded_classes"] == 1
        assert np.isfinite(res["state"]["res.residuals"]).all()


@pytest.mark.parametrize("name", ["se_B1", "se_B2"])
def test_ep_shard_encoder_matches_jax(runs, name):
    """`shard_encoder`: each rank encodes half the fused batch (B 1: one
    of the two clouds; B 2: two of four), the features gathered; the
    state equals the port's EP run with the whole batch on every rank
    (tests/test_ep.py's check), is near JAX's sharded-encoder run, and
    the summary is JAX's."""
    want, got, _, _ = runs
    (jstate, jsummary), = want[name]
    res = _ok(got[0][name])[0]
    plain = _ok(got[0][name.replace("se", "plain")])[0]
    assert_mixture_close(res["state"], plain["state"], names=("mu", "c"))
    assert_near_jax(res["state"], jstate, names=("mu", "c"))
    summaries_equal(res["summary"], jsummary)
    assert res["summary"]["acc1"] == plain["summary"]["acc1"]


def test_ep_continual_resume_matches_jax(runs):
    """Two halves of a stream, the second from the first's full-K carry
    (K 5: the splice pads the carry onto the ranks again): each half's
    state is the replicated chain's, near JAX's, its summary JAX's, and
    the step count goes on."""
    want, got, _, _ = runs
    for part in range(2):
        jstate, jsummary = want["continual"][part]
        res = _ok(got[0]["continual"])[part]
        assert_mixture_close(res["state"], res["replicated"])
        assert_near_jax(res["state"], jstate)
        summaries_equal(res["summary"], jsummary)
    assert got[0]["continual"][1]["state"]["step"] == T


def test_streams_ep_on_a_grid_of_four_matches_jax(runs):
    """DP × EP on a 2 × 2 grid of gloo ranks (streams 0, 1 on data row 0,
    streams 2, 3 on row 1, each stream's classes over its row's two
    ranks): every stream's acc@1, in stream order on every rank, equals
    JAX's run_streams_ep on a (2, 2) mesh, and each row's states are near
    JAX's."""
    want, _, got4, _ = runs
    jstates, jsummary = want["dp_ep"]
    for rank in range(4):
        res = _ok(got4[rank]["dp_ep"])
        assert res["grid"] == (2, 2, rank // 2, rank % 2)
        assert res["summary"]["acc1_per_stream"] == pytest.approx(
            jsummary["acc1_per_stream"], abs=1e-5)
        assert res["summary"]["n_class_shards"] == 2
        row = rank // 2
        want_mu = np.asarray(jstates.method_state.mu)[2 * row:2 * row + 2]
        np.testing.assert_allclose(res["mu"], want_mu, rtol=0,
                                   atol=CROSS * np.abs(want_mu).max())


@pytest.mark.parametrize("name", ["continual", "vmap"])
def test_cli_dist_mode_ep_writes_the_jax_results(runs, name):
    """`--dist-mode ep --continual true` and `--vmap-corruptions true
    --dist-mode ep` at world 2 over two corruptions: rank 0's
    results.json is the JAX CLI's (the same weights, residuals off), no
    results_zs.json, and rank 1 writes nothing."""
    want, got, _, tmp = runs
    for rank in range(2):
        assert _ok(got[rank][f"cli_{name}"])["acc1"] == want[f"cli_{name}"]
    port = tmp / f"port_{name}" / "run"
    assert json.loads((port / "results.json").read_text()) == json.loads(
        (tmp / f"jax_{name}" / "run" / "results.json").read_text())
    assert not (port / "results_zs.json").exists()
    if name == "continual":
        assert got[0]["cli_continual"]["steps"] == {
            "uniform": [0, 4], "gaussian": [4, 8]}


@pytest.mark.parametrize("argv", [
    ["--ep-shard-encoder", "true"],
    ["--dist-mode", "sharded", "--ep-shard-encoder", "true"],
    ["--dist-mode", "ep", "--ep-shard-encoder", "true",
     "--dota-use-mode-dota", "false", "--dota-use-adaptive-dota", "true"],
])
def test_ep_flag_validation_carries_jax_messages(argv):
    """The encoder-sharding lever outside EP, and with a method of one
    forward a step: JAX's ValueError, word for word; every method and
    `--vmap-corruptions` / `--continual` parse with `--dist-mode ep`."""
    with pytest.raises(ValueError) as w:
        jcfg.parse_args(argv)
    with pytest.raises(ValueError) as g:
        pcfg.parse_args(argv)
    assert str(g.value) == str(w.value)
    for ok in (["--dist-mode", "ep", "--vmap-corruptions", "true"],
               ["--dist-mode", "ep", "--continual", "true"],
               ["--dist-mode", "ep", "--dota-use-mode-dota", "false"]):
        assert pcfg.parse_args(ok).run.dist_mode == "ep"


def test_make_ep_step_fn_refuses_shard_encoder_with_jax_messages():
    """Every method builds a class-sharded step; `shard_encoder` with a
    method of one forward a step raises JAX's message."""
    flag_sets = [dict(use_dota=True, use_mode_dota=False),
                 dict(use_mode_dota=False, use_gmm_dota=True),
                 dict(use_mode_dota=False, use_adaptive_dota=True),
                 dict(use_mode_dota=False)]
    shard = ep.ClassShard(None, 0, 2, 8)
    jmodel = jax_create_uni3d(jcfg.ModelConfig(**SMALL))
    for flags in [dict(use_mode_dota=True)] + flag_sets:
        cfg = pcfg.Config(model=pcfg.ModelConfig(**SMALL),
                          dota=pcfg.DotaConfig(**flags))
        assert callable(ep.make_ep_step_fn(cfg, lambda x: x, shard))
    for flags in flag_sets:
        jc = jcfg.Config(model=jcfg.ModelConfig(**SMALL),
                         dota=jcfg.DotaConfig(**flags))
        pc = pcfg.Config(model=pcfg.ModelConfig(**SMALL),
                         dota=pcfg.DotaConfig(**flags))
        with pytest.raises(ValueError) as w:
            jep.make_ep_step_fn(jc, jmodel, "classes", 8, 2,
                                shard_encoder=True)
        with pytest.raises(ValueError) as g:
            ep.make_ep_step_fn(pc, lambda x: x, shard, shard_encoder=True)
        assert str(g.value) == str(w.value)


def test_state_leaf_classification_spec():
    """Which tensor of each method's carry shards over the class group
    (tests/test_ep.py's spec, the port's field names: the Adam moments
    are res_state.mu / nu), matched by exact name: a lookalike ('lam_inv',
    'prng') does not replicate."""
    text = torch.eye(4, 8)
    spec = {
        "mode": (dict(use_mode_dota=True, mode_M=2, res_learning=True),
                 {"method_state.mu": True, "method_state.var": True,
                  "method_state.pi": True, "method_state.c": True,
                  "method_state.class_counts": True,
                  "method_state.t": False, "res_state.residuals": True,
                  "res_state.mu": True, "res_state.nu": True,
                  "res_state.count": False, "generator": False}),
        "cache": (dict(use_mode_dota=False),
                  {"method_state.feats": True, "method_state.conf": True,
                   "method_state.probs": True, "method_state.counts": True,
                   "method_state.valid": True, "generator": False}),
        "dota": (dict(use_dota=True, use_mode_dota=False),
                 {"method_state.mu": True, "method_state.c": True,
                  "method_state.sigma": True, "method_state.lam": False,
                  "method_state.cum_soft_labels": False,
                  "method_state.prior_step": False, "generator": False}),
        "gmm": (dict(use_gmm_dota=True, use_mode_dota=False),
                {"method_state.mu": True, "method_state.sigma": True,
                 "method_state.sigma_reg": True, "method_state.pi": True,
                 "method_state.C": True, "method_state.class_counts": True,
                 "method_state.total_samples": False, "generator": False}),
        "adaptive": (dict(use_adaptive_dota=True, use_mode_dota=False),
                     {"method_state.mu": True, "method_state.var": True,
                      "method_state.pi": True, "method_state.c": True,
                      "method_state.mask": True,
                      "method_state.class_counts": True,
                      "method_state.t": False,
                      "method_state.fit_calls": False, "generator": False}),
    }
    for name, (dota, expected) in spec.items():
        cfg = pcfg.Config(model=pcfg.ModelConfig(**SMALL),
                          dota=pcfg.DotaConfig(**dota))
        state = engine.init_state(cfg, text, 0)
        assert ep.leaf_classification(state) == expected, name
    assert ep._is_replicated_path(("method_state", "lam"))
    assert not ep._is_replicated_path(("method_state", "lam_inv"))
    assert not ep._is_replicated_path(("prng",))
    assert ep._is_replicated_path(("rng",))


def test_padded_state_splices_a_full_k_carry():
    """`make_padded_state` of a full-K carry over 3 blocks (K 5 → 6), then
    `strip_padded_state`: the carry back, bitwise; the pad row is a fresh
    init's (the unit e_0 anchor, frozen) and the trailing class axes span
    K_pad."""
    cfg = pcfg.Config(model=pcfg.ModelConfig(**SMALL),
                      dota=pcfg.DotaConfig(use_dota=True,
                                           use_mode_dota=False))
    text = torch.from_numpy(text_of(np.random.default_rng(3), 5))
    carry = engine.init_state(cfg, text, 7)
    carry.method_state = carry.method_state._replace(
        mu=carry.method_state.mu + 0.5,
        cum_soft_labels=torch.arange(5.0)[None])
    padded = ep.make_padded_state(cfg, text, 7, 3, initial_state=carry)
    assert padded.method_state.mu.shape == (6, D)
    assert padded.method_state.cum_soft_labels.shape == (1, 6)
    np.testing.assert_array_equal(padded.method_state.mu[5].numpy(),
                                  np.full(D, 0.001, np.float32))
    back = ep.strip_padded_state(padded, 5)
    for a, b in zip(back.method_state, carry.method_state):
        assert torch.equal(a, b)
