"""The port's pipeline-parallel trunk (`parallel/pp.py`, the GPipe schedule)
over torch.distributed against the JAX package on its CPU mesh, at the
small dims of tests/test_pp.py (Uni3D and ULIP-2 width 48, 4 heads,
depth 4 or 8; OpenShape's PPTA width 48, depth 4, with and without
`rel_pe`; fp32, and Uni3D in bf16).

The port's worlds of two, four and eight ranks are processes over gloo,
spawned once for the module (`torch_dist_worker.py`, program `pp`),
which run every case on a (stage, model, data) grid of their world and
hand back their results while JAX runs its side.  JAX's own tests hold
its `make_pp_forward_*` equal to its plain forward within 1e-5; the port
is held to both: the plain forwards, gradients, train steps and
trajectories here, and JAX's pipelined forward itself for each backbone
at S = 2 (`test_port_matches_jax_pipelined_forward`).

Contracts, as tests/test_pp.py states them:
  * forwards within rtol/atol 1e-5 of JAX's plain forward (bf16: within
    2e-2 of the port's plain bf16 forward), at S ∈ {2, 4, 8}, with PP ×
    DP, PP × TP and PP × TP × DP;
  * gradients through the schedule within rtol 1e-4, atol 1e-5, the
    blocks' on their stage's rank, the replicated ones on every rank;
  * two AdamW steps (the first at lr 0 under warmup): the loss within
    rtol 1e-5, the parameters within `PARAM_ATOL` (the k LayerNorm's
    bias, whose exact gradient is 0, within `NOISE_ATOL`: see
    tests/test_torch_dp_train.py), on each rank and gathered whole on
    rank 0, against JAX's single-device steps for Uni3D (GPipe and
    PP × TP) and the port's one-process step for ULIP-2 and OpenShape
    (`train.train_step`, which tests/test_torch_train.py holds against
    JAX's);
  * the MODE-DOTA trajectory with residuals: logits within 1e-4 of JAX's
    replicated run (ULIP-2: the port's), `correct` equal;
  * each stage holds its blocks under their global names, and the decay
    mask is one process's;
  * a depth or a batch that does not divide raises JAX's error text;
  * only the activations ride the ring: every shift sends one (Bm, N,
    width) buffer, ULIP's positions and PPTA's deltas never.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import uni_adapter_tpu.train as jtrain
from test_torch_tp import key_noise
from torch_dist_worker import build_pp_model, collect, start_world
from uni_adapter_tpu import config as jcfg
from uni_adapter_tpu import engine as jengine
from uni_adapter_tpu.models import ppta as jppta
from uni_adapter_tpu.models.losses import uni3d_text_image_loss
from uni_adapter_tpu.models.pointbert import ULIP as JULIP
from uni_adapter_tpu.models.uni3d import Uni3D as JUni3D
from uni_adapter_tpu.parallel import pp as jpp
from uni_adapter_torch import config as pcfg
from uni_adapter_torch import train as ptrain
from uni_adapter_torch.models import uni3d
from uni_adapter_torch.weights import from_jax_params, from_jax_stacked
from torch_threads import one_torch_thread  # noqa: F401

UNI3D = dict(trans_dim=48, embed_dim=32, num_group=16, group_size=8,
             encoder_dim=24, num_heads=4)
ULIP = dict(trans_dim=48, num_heads=4, num_group=16, group_size=8,
            encoder_dim=24, embed_dim=32)
PPTA = dict(dim=48, depth=4, heads=4, mlp_dim=96, sa_dim=24, patches=16,
            prad=0.4, nsamp=8)
OUT, K, N, T = 32, 5, 64, 4
TOL = 1e-5
OPTIMIZER = dict(lr=1e-3, total_steps=4, warmup_steps=1)
#: as tests/test_torch_dp_train.py: fp32 sums in other orders; the k
#: LayerNorm's bias has an exact gradient of 0, so Adam normalises noise
METRIC_RTOL, PARAM_ATOL, NOISE_ATOL = 1e-5, 2e-6, 2.5e-3

#: the forwards: name -> (world, model, inputs, S, n_micro, tp, dp)
FORWARDS = {
    "uni3d_2_4_2": (2, "u4", "pc8", 2, 2, 1, 1),
    "uni3d_4_4_2": (4, "u4", "pc8", 4, 2, 1, 1),
    "uni3d_4_8_4": (4, "u8", "pc8", 4, 4, 1, 1),
    "uni3d_8_8_2": (8, "u8", "pc8", 8, 2, 1, 1),
    "ulip_2_4_2": (2, "l4", "pts", 2, 2, 1, 1),
    "ulip_4_4_4": (4, "l4", "pts", 4, 4, 1, 1),
    "ulip_il": (2, "l4", "pts", 2, 2, 1, 1),
    "dp": (8, "u4", "pc8", 4, 2, 1, 2),
    "tp": (4, "u4", "pc8", 2, 2, 2, 1),
    "tp_dp": (8, "u4", "pc8", 2, 2, 2, 2),
    "openshape_False": (2, "o_False", "os", 2, 2, 1, 1),
    "openshape_True": (2, "o_True", "os", 2, 2, 1, 1),
    "bf16": (2, "u4_bf16", "pc4", 2, 2, 1, 1),
}


def drawn_params(model, *example, seed=0):
    """Parameters of `model`'s tree drawn with numpy (no compiled init):
    Dense kernels normal / √fan-in, LayerNorm and BatchNorm scales and
    variances about 1, everything else normal(0, 0.05)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *example)

    def leaf(path, s):
        name = path[-1].key
        z = rng.standard_normal(s.shape)
        if name == "kernel":
            return (z / np.sqrt(s.shape[0])).astype(np.float32)
        if name in ("scale", "var"):
            return (1 + 0.05 * np.abs(z)).astype(np.float32)
        return (0.05 * z).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_models():
    """{name: (JAX module, params, port kind, port dims, dtype)}."""
    z6 = jnp.zeros((1, N, 6))
    z3 = jnp.zeros((1, N, 3))
    perturbed_params = drawn_params

    out = {}
    for name, depth in (("u4", 4), ("u8", 8)):
        m = JUni3D(**UNI3D, depth=depth, dtype=jnp.float32)
        out[name] = (m, perturbed_params(m, z6), "uni3d",
                     dict(UNI3D, depth=depth), "float32")
    m = JUni3D(**UNI3D, depth=4, dtype=jnp.bfloat16)
    out["u4_bf16"] = (m, out["u4"][1], "uni3d", dict(UNI3D, depth=4),
                      "bfloat16")
    m = JULIP(**ULIP, depth=4, dtype=jnp.float32)
    out["l4"] = (m, perturbed_params(m, z3), "ulip", dict(ULIP, depth=4),
                 "float32")
    for rel_pe in (False, True):
        m = jppta.Projected(preset=jppta.PPTAPreset(**PPTA), out_channel=OUT,
                            rel_pe=rel_pe, dtype=jnp.float32)
        out[f"o_{rel_pe}"] = (m, perturbed_params(m, z3, jnp.concatenate(
            [z3, z3], -1)), "openshape", {"preset": PPTA, "out": OUT,
                                          "rel_pe": rel_pe}, "float32")
    return out


def _text(rng, k):
    t = rng.standard_normal((k, OUT)).astype(np.float32)
    return t / np.linalg.norm(t, axis=1, keepdims=True)


def _dota_configs(vlm3d):
    kw = dict(use_mode_dota=True, mode_M=2, res_learning=True,
              residual_steps=2)
    return (jcfg.Config(model=jcfg.ModelConfig(vlm3d=vlm3d,
                                               compute_dtype="float32"),
                        dota=jcfg.DotaConfig(**kw),
                        cache=jcfg.CacheConfig(cg_max_iter=10)),
            pcfg.Config(model=pcfg.ModelConfig(vlm3d=vlm3d,
                                               compute_dtype="float32"),
                        dota=pcfg.DotaConfig(**kw),
                        cache=pcfg.CacheConfig(cg_max_iter=10)))


def _port_train(model, batches):
    """The port's one-process AdamW steps (`train.train_step`, held against
    JAX's by tests/test_torch_train.py) on `batches`: (metrics, params,
    log-scale), the two-input OpenShape's through `train.loss_grads`."""
    import torch

    m = build_pp_model(*model).requires_grad_(True)
    tx = ptrain.make_optimizer(**OPTIMIZER)
    state = ptrain.init_train_state(m, tx)
    decay = ptrain.decay_mask(m)
    metrics = []
    for b in batches:
        *inputs, text, image = (torch.from_numpy(a) for a in b)
        grads, mt = ptrain.loss_grads(m, state, tuple(inputs), text, image,
                                      torch.ones(text.shape[0]))
        state = ptrain.apply_grads(state, tx, grads, decay)
        metrics.append({k: v.item() for k, v in mt.items()})
    return metrics, {n: p.detach().clone() for n, p in
                     state.params.items()}, state.logit_scale.item()


def _jax_train(m, params, batches, n_inputs):
    """JAX's single-device AdamW steps on `batches`: (metrics, params)."""
    tx = jtrain.make_optimizer(**OPTIMIZER)
    p = params["params"]
    ls = jnp.float32(np.log(1 / 0.07))
    state = jtrain.TrainState(p, ls, tx.init((p, ls)), jnp.int32(0))

    @jax.jit
    def step(state, *args):
        inputs, (text, image) = args[:n_inputs], args[n_inputs:]

        def loss_fn(p, ls):
            out = uni3d_text_image_loss(
                m.apply({"params": p}, *inputs), text, image, jnp.exp(ls),
                mask=jnp.ones((text.shape[0],), jnp.float32), axis_name=None)
            return out["loss"], out
        (_, metrics), grads = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(state.params,
                                                   state.logit_scale)
        return jtrain._apply_grads(state, tx, grads), metrics

    metrics = []
    for b in batches:
        state, mt = step(state, *(jnp.asarray(a) for a in b))
        metrics.append({k: float(v) for k, v in mt.items()})
    return metrics, from_jax_params(jax.tree_util.tree_map(
        np.asarray, state.params)), float(state.logit_scale)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's worlds of two, four and eight (spawned first), then JAX's
    forwards, gradients, train steps and trajectories."""
    tmp = tmp_path_factory.mktemp("pp")
    jm = _jax_models()
    rng = np.random.default_rng(0)
    xs = {"pc8": rng.standard_normal((8, N, 6)).astype(np.float32),
          "pts": rng.standard_normal((4, N, 3)).astype(np.float32)}
    xs["pc4"] = xs["pc8"][:4]
    xyz = rng.standard_normal((4, N, 3)).astype(np.float32)
    xs["os"] = (xyz, np.concatenate([xyz, np.ones_like(xyz)], -1))
    inputs = {k: v if isinstance(v, tuple) else (v,) for k, v in xs.items()}
    ct = rng.standard_normal((4, OUT)).astype(np.float32)
    batches = {k: [(*inputs[x], rng.standard_normal((4, OUT)).astype(
        np.float32), rng.standard_normal((4, OUT)).astype(np.float32))
        for _ in range(2)] for k, x in (("u4", "pc4"), ("l4", "pts"),
                                        ("o_False", "os"))}
    models = {k: (kind, dims, dt, from_jax_params(p))
              for k, (_, p, kind, dims, dt) in jm.items()}
    models["u6"] = ("uni3d", dict(UNI3D, depth=6), "float32",
                    None)
    trng = np.random.default_rng(29)
    text = _text(trng, K)
    pcs = trng.standard_normal((T, 1, N, 3)).astype(np.float32)
    stream = (pcs, np.ones_like(pcs),
              trng.integers(0, K, (T, 1)).astype(np.int32))
    noise = key_noise(jax.random.PRNGKey(7), T, (1, N, 3))

    cases = [dict(name=f"fwd_{n}", type="forward", world=w, model=m,
                  inputs=inputs[x], S=S, n_micro=nm, tp=tp, dp=dp,
                  V=2 if n == "ulip_il" else 1, plain=n == "bf16")
             for n, (w, m, x, S, nm, tp, dp) in FORWARDS.items()]
    cases += [
        dict(name="grad", type="grad", world=2, model="u4",
             inputs=inputs["pc4"], ct=ct, S=2, n_micro=2),
        dict(name="blocks", type="blocks", world=2, model="u4", S=2),
        dict(name="err_batch", type="error", world=2, model="u4",
             inputs=(xs["pc8"][:3],), S=2, n_micro=2),
        dict(name="err_depth", type="error", world=4, model="u6",
             inputs=inputs["pc4"], S=4),
        dict(name="train_tp", type="train", world=4, model="u4", S=2, tp=2,
             n_micro=2, optimizer=OPTIMIZER, batches=batches["u4"]),
        dict(name="train_dp", type="train", world=4, model="u4", S=2, dp=2,
             n_micro=2, optimizer=OPTIMIZER, batches=batches["u4"]),
        dict(name="ring", type="ring", world=4, src=3)]
    cases += [dict(name=f"train_{k}", type="train", world=2, model=k, S=2,
                   n_micro=2, optimizer=OPTIMIZER, batches=batches[k])
              for k in ("u4", "l4", "o_False")]
    for kind, model in (("uni3d", "u4"), ("ulip", "l4")):
        cases.append(dict(name=f"traj_{kind}", type="trajectory", world=2,
                          model=model, kind=kind, S=2,
                          cfg=_dota_configs(kind)[1], text=text,
                          stream=stream, noise=noise,
                          replicated=kind == "ulip"))
    spec = {"models": models, "cases": cases}
    procs = {w: start_world("pp", spec, tmp / f"w{w}", world=w)
             for w in (2, 4, 8)}

    want = {"inputs": xs}
    for name, (m, params, *_rest) in jm.items():
        if name == "u4_bf16":
            continue
        x = inputs[{"u": "pc8", "l": "pts", "o": "os"}[name[0]]]
        want[name] = np.asarray(jax.jit(m.apply)(
            params, *(jnp.asarray(a) for a in x)), np.float32)
    m, params = jm["u4"][:2]
    pc4 = jnp.asarray(xs["pc4"])
    want["grad"] = from_jax_params(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(lambda p: jnp.sum(
            m.apply(p, pc4) * ct)))(params)))
    want["stacked"] = from_jax_stacked(
        jpp.stack_trunk_params(params["params"]["point_encoder"], 4, 2),
        "point_encoder.blocks")
    want["decay"] = ptrain.decay_mask(uni3d.Uni3D(**UNI3D, depth=4))
    want["train_u4"] = _jax_train(jm["u4"][0], jm["u4"][1], batches["u4"], 1)
    for k in ("l4", "o_False"):
        want[f"train_{k}"] = _port_train(models[k], batches[k])
    for kind, name in (("uni3d", "u4"),):
        jc = _dota_configs(kind)[0]
        m, params = jm[name][:2]
        _, outs = jax.jit(jengine.make_scan_fn(jc, m))(
            params, jnp.asarray(text), jengine.init_state(
                jc, jnp.asarray(text), jax.random.PRNGKey(7)),
            *(jnp.asarray(a) for a in stream))
        want[f"traj_{kind}"] = (np.asarray(outs.final_logits),
                                np.asarray(outs.correct))
    # JAX's pipelined forwards themselves at S = 2
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("stage",))
    for name, make, x in (("u4", jpp.make_pp_forward_uni3d, "pc8"),):
        m, params = jm[name][:2]
        prepare, fwd = make(m, mesh, n_micro=2)
        want[f"jax_pp_{name}"] = np.asarray(fwd(prepare(params), *(
            jnp.asarray(a) for a in inputs[x])))
    m6 = JUni3D(**UNI3D, depth=6, dtype=jnp.float32)
    try:
        jpp.make_pp_forward_uni3d(m6, Mesh(np.asarray(jax.devices()[:4]),
                                           ("stage",)))[0](
            jax.jit(m6.init)(jax.random.PRNGKey(0), jnp.zeros((1, N, 6))))
    except ValueError as e:
        want["err_depth"] = str(e)
    prepare, fwd = jpp.make_pp_forward_uni3d(jm["u4"][0], mesh, n_micro=2)
    try:
        fwd(prepare(jm["u4"][1]), jnp.asarray(xs["pc8"][:3]))
    except ValueError as e:
        want["err_batch"] = str(e)
    got = {w: collect(p, tmp / f"w{w}", timeout=300.0)
           for w, p in procs.items()}
    return want, got


def _ok(result):
    assert not (isinstance(result, dict) and "error" in result), \
        result.get("error")
    return result


def _close(got: dict, want: dict, rtol, atol, names=None):
    names = got if names is None else names
    for n in names:
        assert n in want, n
        np.testing.assert_allclose(got[n], want[n], rtol=rtol, atol=atol,
                                   err_msg=n)


def _forward(runs, name):
    want, got = runs
    w = FORWARDS[name][0]
    return [_ok(got[w][r][f"fwd_{name}"]) for r in range(w)], want


@pytest.mark.parametrize("name", ["uni3d_2_4_2", "uni3d_4_4_2",
                                  "uni3d_4_8_4", "uni3d_8_8_2"])
def test_pp_uni3d_matches_plain_forward(runs, name):
    """Every rank's features within 1e-5 of JAX's plain forward, at 2, 4
    and 8 stages, 1 or 2 blocks a stage, 2 or 4 microbatches."""
    res, want = _forward(runs, name)
    for r in res:
        np.testing.assert_allclose(r["feat"], want[FORWARDS[name][1]],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["ulip_2_4_2", "ulip_4_4_4"])
def test_pp_ulip_matches_plain_forward(runs, name):
    res, want = _forward(runs, name)
    for r in res:
        np.testing.assert_allclose(r["feat"], want["l4"], rtol=TOL, atol=TOL)


def test_pp_dp_composition_matches_plain_forward(runs):
    """PP × DP on a 4 × 2 (stage, data) grid: each data rank runs its rows
    of every microbatch, the trunk's output gathered over the data axis;
    within 1e-5 of the plain forward on every rank."""
    res, want = _forward(runs, "dp")
    for r in res:
        np.testing.assert_allclose(r["feat"], want["u4"], rtol=TOL, atol=TOL)
        assert [k for k, *_ in r["log"]][-1] == "gather"


def test_pp_tp_composition_matches_plain_forward(runs):
    """PP × TP on a 2 × 2 (stage, model) grid: each stage's blocks
    Megatron-sharded over its model pair, three sums a block yielded
    inside the ring."""
    res, want = _forward(runs, "tp")
    for r in res:
        np.testing.assert_allclose(r["feat"], want["u4"], rtol=TOL, atol=TOL)
        kinds = [k for k, *_ in r["log"]]
        # 2 blocks a stage, 2 microbatches: 12 sums, then the broadcast
        assert kinds.count("sum") == 12 and kinds[-1] == "broadcast"


def test_pp_tp_dp_3d_composition_matches_plain_forward(runs):
    """The (stage, model, data) = (2, 2, 2) grid: depth over the stages,
    block matrices over the model pairs, microbatch rows over the data
    pairs; within 1e-5 on all eight ranks."""
    res, want = _forward(runs, "tp_dp")
    for r in res:
        np.testing.assert_allclose(r["feat"], want["u4"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("rel_pe", [False, True])
def test_pp_openshape_matches_plain_forward(runs, rel_pe):
    res, want = _forward(runs, f"openshape_{rel_pe}")
    for r in res:
        np.testing.assert_allclose(r["feat"], want[f"o_{rel_pe}"], rtol=TOL,
                                   atol=TOL)


def test_pp_bf16_matches_plain_forward(runs):
    """Under bf16 compute the pipeline stays within bf16 tolerance (2e-2)
    of the plain bf16 forward (the port's, one process: JAX's test holds
    its pipeline to its own plain forward)."""
    res, _ = _forward(runs, "bf16")
    for r in res:
        np.testing.assert_allclose(r["feat"], r["plain"], rtol=2e-2,
                                   atol=2e-2)


def test_port_matches_jax_pipelined_forward(runs):
    """The port's GPipe forward at S = 2 within 1e-5 of JAX's
    `make_pp_forward_uni3d` on a 2-device stage mesh."""
    res, want = _forward(runs, "uni3d_2_4_2")
    for r in res:
        np.testing.assert_allclose(r["feat"], want["jax_pp_u4"], rtol=TOL,
                                   atol=TOL)


def test_pp_stage_shards_hold_distinct_blocks(runs):
    """Stage s holds blocks 2s and 2s + 1 under their global names, equal
    to JAX's stacked[s, j] (`stack_trunk_params`), and nothing of another
    stage's."""
    want, got = runs
    for r in range(2):
        res = _ok(got[2][r]["blocks"])
        assert res["stage"] == r
        held = {n for n in res["params"] if ".blocks." in n}
        idx = {int(n.split(".")[2]) for n in held}
        assert idx == {2 * r, 2 * r + 1}
        for n in held:
            np.testing.assert_array_equal(res["params"][n],
                                          want["stacked"][n].numpy())


def test_pp_rejects_indivisible_depth(runs):
    """Six blocks over four stages: JAX's ValueError text."""
    want, got = runs
    for r in range(4):
        assert got[4][r]["err_depth"] == want["err_depth"]
        assert "not divisible" in want["err_depth"]


def test_pp_grad_matches_plain_forward(runs):
    """Gradients through the schedule within rtol 1e-4, atol 1e-5 of JAX's
    plain forward's: each stage's blocks on its rank, the replicated
    embedding and head on both."""
    want, got = runs
    seen = set()
    for r in range(2):
        grads = _ok(got[2][r]["grad"])["grads"]
        assert all(g is not None for g in grads.values())
        _close(grads, {n: t.numpy() for n, t in want["grad"].items()}, 1e-4,
               1e-5)
        seen |= set(grads)
    assert seen == set(want["grad"])


@pytest.mark.parametrize("model", ["u4", "l4", "o_False"])
def test_pp_train_step_matches_single_device(runs, model):
    """Two AdamW steps of the PP train step (Uni3D against JAX's
    single-device step; ULIP-2 and OpenShape's two-input convention
    against the port's one-process step): the metrics, every rank's
    parameters, and the whole state gathered on rank 0."""
    want, got = runs
    jmetrics, jparams, jls = want[f"train_{model}"]
    jparams = {n: t.numpy() for n, t in jparams.items()}
    _check_train([_ok(got[2][r][f"train_{model}"]) for r in range(2)],
                 jmetrics, jparams, jls)


def _check_train(ranks, jmetrics, jparams, jls):
    for res in ranks:
        for g, w in zip(res["metrics"], jmetrics):
            for k in ("loss", "pc_text_acc", "pc_image_acc"):
                if k in w:
                    np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL,
                                               err_msg=k)
        np.testing.assert_allclose(res["logit_scale"], jls, rtol=1e-6)
    full = ranks[0]["full"]
    assert set(full) == set(jparams)
    for n, p in full.items():
        atol = NOISE_ATOL if "k_norm.bias" in n else PARAM_ATOL
        np.testing.assert_allclose(p, jparams[n], rtol=1e-4, atol=atol,
                                   err_msg=n)
    for res in ranks:
        for n, p in res["params"].items():
            if p.shape == full[n].shape:
                np.testing.assert_array_equal(p, full[n], err_msg=n)


@pytest.mark.parametrize("name", ["tp", "dp"])
def test_pp_tp_train_step_matches_single_device(runs, name):
    """PP × TP training on a 2 × 2 (stage, model) grid: the blocks' shards
    and moments on their ranks, the gathered state within the train-step
    tolerances of JAX's single-device steps; and PP × DP on a 2 × 2
    (stage, data) grid, each data rank running its rows of every
    microbatch, the blocks' gradients summed over the data pair."""
    want, got = runs
    jmetrics, jparams, jls = want["train_u4"]
    ranks = [_ok(got[4][r][f"train_{name}"]) for r in range(4)]
    sharded = [n for n, p in ranks[0]["params"].items()
               if p.shape != ranks[0]["full"][n].shape]
    assert any("q_proj.weight" in n for n in sharded) == (name == "tp")
    _check_train(ranks, jmetrics, {n: t.numpy() for n, t in jparams.items()},
                 jls)


def test_ring_shift_and_broadcast_transpose_as_jax(runs):
    """`collectives.ring_shift` at world 4 gives each rank the previous
    rank's tensor and, as the gradient, the next rank's cotangent (JAX's
    ppermute over `ring_perm` and its transpose); `broadcast_from` gives
    every rank rank 3's tensor and hands rank 3 one copy of its own
    cotangent, the others none."""
    _, got = runs
    for r in range(4):
        res = _ok(got[4][r]["ring"])
        y, g = res["shift"]
        np.testing.assert_array_equal(y, np.full((2, 3), (r - 1) % 4))
        np.testing.assert_array_equal(g, np.full((2, 3), (r + 1) % 4 + 1))
        y, g = res["broadcast"]
        np.testing.assert_array_equal(y, np.full((2, 3), 3.0))
        np.testing.assert_array_equal(g, np.full((2, 3), 4.0 if r == 3
                                                 else 0.0))


@pytest.mark.parametrize("kind", ["uni3d", "ulip"])
def test_pp_engine_step_trajectory_matches(runs, kind):
    """The MODE-DOTA scan with residuals on the PP encoder at world 2 (JAX's
    noise fed): every step's final logits within 1e-4 of the replicated
    trajectory, `correct` equal: JAX's for Uni3D, the port's one-process
    run for ULIP-2 (its positions re-taken on each stage)."""
    want, got = runs
    for r in range(2):
        res = _ok(got[2][r][f"traj_{kind}"])
        logits, correct = (want[f"traj_{kind}"] if kind == "uni3d" else
                           (res["replicated"], res["replicated_correct"]))
        np.testing.assert_allclose(res["final_logits"], logits, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(res["correct"], correct)


def test_decay_mask_stacking_invariant(runs):
    """A stage's decay mask marks its blocks' leaves as one process's mask
    does under the same global names (Dense weights, not biases, norm
    gains or the cls tokens)."""
    want, got = runs
    for r in range(2):
        mask = _ok(got[2][r]["blocks"])["decay"]
        for n, m in mask.items():
            assert m == want["decay"][n], n
        assert any(m for n, m in mask.items() if n.endswith("q_proj.weight"))
        assert not any(m for n, m in mask.items() if n.endswith(".bias")
                       or "cls" in n or "norm" in n)


def test_pp_rejects_indivisible_batch(runs):
    """Three clouds in two microbatches: JAX's ValueError text."""
    want, got = runs
    for r in range(2):
        assert got[2][r]["err_batch"] == want["err_batch"]


@pytest.mark.parametrize("name", ["ulip_2_4_2", "ulip_il"])
def test_ulip_ring_rotates_activations_only(runs, name):
    """ULIP's positions are a per-microbatch constant each stage re-takes:
    every shift sends one (2, 17, 48) activation buffer, never the (x,
    pos) pair, GPipe and interleaved alike."""
    _check_ring(_forward(runs, name)[0], (2, 17, 48))


@pytest.mark.parametrize("rel_pe", [False, True])
def test_openshape_ring_rotates_activations_only(runs, rel_pe):
    """With rel_pe the (Bm, 17, 17, 3) deltas stay local: every shift sends
    one (2, 17, 48) activation buffer."""
    _check_ring(_forward(runs, f"openshape_{rel_pe}")[0], (2, 17, 48))


def _check_ring(ranks, shape):
    sent = 0
    for r in ranks:
        shifts = [(b, s) for k, b, s in r["log"] if k == "shift"]
        assert shifts
        for b, s in shifts:
            assert s is None or (s == shape and b == 4 * np.prod(shape))
        sent += sum(s is not None for _, s in shifts)
        assert [k for k, *_ in r["log"]][-1] == "broadcast"
    assert sent > 0
