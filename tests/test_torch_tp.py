"""The port's tensor-parallel trunk (`parallel/tp.py`) over torch.distributed
against the JAX package's `parallel/tp.py` on its CPU mesh, at the small
dims of tests/test_tp.py (Uni3D width 48, 4 heads, 2 blocks; ULIP-2 and
OpenShape at widths 64 with 4 heads, OpenShape with `rel_pe`; fp32).

The port's worlds of two and four ranks are processes over gloo, spawned
once for the module (`torch_dist_worker.py`, program `tp`), which run
every case and hand back their results while JAX runs its side: the
replicated forwards, the MODE-DOTA trajectory with residuals (the port
fed JAX's noise) and the replicated runs EP × TP is held to.

Contracts, as tests/test_tp.py and tests/test_ep.py state them:
  * each parameter's spec and shard shape follow JAX's `tp_param_specs`
    (weights transposed), a fused qkv's rank holding its heads' q, k and
    v columns;
  * TP forwards at worlds 2 and 4 within 2e-5 of JAX's replicated
    forward, three sums a block of the EVA trunk and two a ViT block
    (the analogue of the all-reduce in JAX's HLO);
  * DP × TP on a 2 × 2 (data, model) grid within 2e-5;
  * the MODE-DOTA trajectory with residuals: logits within 1e-4 of JAX's
    replicated run's, `correct` equal;
  * EP × TP on a 2 × 2 (classes, model) grid, MODE-DOTA and the cache:
    the state within rtol 2e-4, atol 2e-5 of JAX's replicated run, acc@1
    equal;
  * a model whose widths do not divide raises JAX's error text.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from test_torch_vit_backbones import SMALL_ULIP, perturbed_params
from torch_dist_worker import collect, start_world
from uni_adapter_tpu import config as jcfg
from uni_adapter_tpu import engine as jengine
from uni_adapter_tpu.models import ppta as jppta
from uni_adapter_tpu.models.pointbert import create_ulip as jax_create_ulip
from uni_adapter_tpu.models.uni3d import Uni3D as JUni3D
from uni_adapter_tpu.parallel import tp as jtp
from uni_adapter_tpu.parallel.trunk import prepare_trunk_parallel
from uni_adapter_torch import config as pcfg
from uni_adapter_torch.models import pointbert, ppta, uni3d
from uni_adapter_torch.parallel import tp
from uni_adapter_torch.weights import _module_name, from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

UNI3D = dict(trans_dim=48, embed_dim=32, num_group=8, group_size=8,
             encoder_dim=24, depth=2, num_heads=4)
ULIP = dict(trans_dim=64, depth=2, num_heads=4, num_group=16,
            group_size=8, encoder_dim=32, embed_dim=32)
PPTA = dict(dim=64, depth=2, heads=4, mlp_dim=128, sa_dim=32, patches=16,
            prad=0.4, nsamp=8)
OUT = 32
#: width 40: the SwiGLU hidden width 106 splits over 2 ranks, not over 4
ODD = dict(UNI3D, trans_dim=40, depth=1)
K, D, N, T = 5, 32, 64, 4
TOL = 2e-5


def _jax_models():
    """(JAX module, params, inputs) of each backbone, the port's dims."""
    rng = np.random.default_rng(0)
    pc = rng.standard_normal((4, N, 6)).astype(np.float32)
    xyz = rng.uniform(-0.5, 0.5, (4, 128, 3)).astype(np.float32)
    feats = np.concatenate([xyz, rng.uniform(0, 1, (4, 128, 3))
                            .astype(np.float32)], -1)
    ju = JUni3D(**UNI3D, dtype=jnp.float32)
    jl = jax_create_ulip(jcfg.ModelConfig(
        compute_dtype="float32", use_pallas_fps=False, use_pallas_knn=False,
        use_pallas_attention=False, **SMALL_ULIP))
    jo = jppta.Projected(preset=jppta.PPTAPreset(**PPTA), out_channel=OUT,
                         dtype=jnp.float32, rel_pe=True)
    jodd = JUni3D(**ODD, dtype=jnp.float32)
    out = {}
    for kind, m, x in (("uni3d", ju, (pc,)), ("ulip", jl, (xyz,)),
                       ("openshape", jo, (xyz, feats)),
                       ("uni3d_odd", jodd, (pc,))):
        out[kind] = (m, perturbed_params(m, *(jnp.asarray(a) for a in x)), x)
    return out


def _port_dims(kind):
    if kind == "uni3d":
        return UNI3D
    if kind == "uni3d_odd":
        return ODD
    if kind == "ulip":
        return ULIP
    return {"preset": PPTA, "out": OUT, "rel_pe": True}


def key_noise(key, n_steps, shape):
    """The noise MODE-DOTA's step draws from the carried key, n_steps
    steps (split, normal from the second half)."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


def _configs(**dota):
    kw = dict(use_dota=False, use_mode_dota=True, mode_M=2,
              res_learning=True, residual_steps=2)
    kw.update(dota)
    return (jcfg.Config(model=jcfg.ModelConfig(compute_dtype="float32"),
                        dota=jcfg.DotaConfig(**kw)),
            pcfg.Config(model=pcfg.ModelConfig(compute_dtype="float32"),
                        dota=pcfg.DotaConfig(**kw)))


def _cache_configs():
    cc = dict(shot_capacity=3, threshold=0.3, lambda_reg=0.11, beta=150.0)
    dc = dict(use_dota=False, use_mode_dota=False)
    return (jcfg.Config(model=jcfg.ModelConfig(compute_dtype="float32"),
                        dota=jcfg.DotaConfig(**dc),
                        cache=jcfg.CacheConfig(**cc)),
            pcfg.Config(model=pcfg.ModelConfig(compute_dtype="float32"),
                        dota=pcfg.DotaConfig(**dc),
                        cache=pcfg.CacheConfig(**cc)))


def _stream(rng, B, k=K):
    pcs = rng.standard_normal((T, B, N, 3)).astype(np.float32)
    return pcs, np.ones_like(pcs), rng.integers(0, k, (T, B)).astype(
        np.int32)


def _text(rng, k):
    t = rng.standard_normal((k, D)).astype(np.float32)
    return t / np.linalg.norm(t, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's worlds of two and four (spawned first), then JAX's
    replicated forwards and runs."""
    tmp = tmp_path_factory.mktemp("tp")
    jm = _jax_models()
    rng = np.random.default_rng(1)
    models = {k: (_port_dims(k), from_jax_params(p))
              for k, (_, p, _) in jm.items()}
    clouds = {k: x for k, (_, _, x) in jm.items()}

    # tests/test_tp.py's trajectory: its init weights, data and key
    jtraj, ptraj = _configs()
    ju = jm["uni3d"][0]
    init = ju.init(jax.random.PRNGKey(0), jnp.zeros((1, N, 6)))
    trng = np.random.default_rng(3)
    text = _text(trng, K)
    pcs = trng.standard_normal((T, 1, N, 3)).astype(np.float32)
    stream = (pcs, np.ones_like(pcs),
              trng.integers(0, K, (T, 1)).astype(np.int32))
    noise = key_noise(jax.random.PRNGKey(7), T, (1, N, 3))
    trajectory = {"cfg": ptraj, "text": text, "stream": stream,
                  "noise": noise, "state_dict": from_jax_params(init)}

    dp_clouds = rng.standard_normal((4, N, 6)).astype(np.float32)
    jmode, pmode = _configs(res_learning=False)
    jcache, pcache = _cache_configs()
    ep_cases = {"mode": (jmode, pmode, _text(rng, 6), _stream(rng, 2, 6),
                         key_noise(jax.random.PRNGKey(42), T, (2, N, 3))),
                "cache": (jcache, pcache, _text(rng, K), _stream(rng, 1),
                          None)}
    ep_tp = {n: {"cfg": c[1], "text": c[2], "stream": c[3], "noise": c[4]}
             for n, c in ep_cases.items()}
    tp_cfg = pcfg.Config(run=pcfg.RunConfig(trunk_parallel="tp"))
    base = {"models": models, "clouds": clouds, "tp_cfg": tp_cfg}
    procs = start_world("tp", {**base, "trajectory": trajectory},
                        tmp / "w2")
    procs4 = start_world("tp", {**base, "dp_clouds": dp_clouds,
                                "ep_tp": ep_tp}, tmp / "w4", world=4)

    want = {}
    for kind, (m, params, x) in jm.items():
        want[kind] = np.asarray(jax.jit(m.apply)(
            params, *(jnp.asarray(a) for a in x)))
    m, params, _ = jm["uni3d"]
    want["dp"] = np.asarray(jax.jit(m.apply)(params, jnp.asarray(dp_clouds)))
    _, outs = jax.jit(jengine.make_scan_fn(jtraj, m))(
        init, jnp.asarray(text), jengine.init_state(
            jtraj, jnp.asarray(text), jax.random.PRNGKey(7)),
        *(jnp.asarray(a) for a in stream))
    want["trajectory"] = outs
    for name, (jc, _, etext, estream, _) in ep_cases.items():
        want[f"ep_{name}"] = jengine.run_stream_scan(
            jc, m, params, jnp.asarray(etext),
            *(jnp.asarray(a) for a in estream), seed=42)
    m, params, _ = jm["uni3d_odd"]
    try:
        prepare_trunk_parallel(jcfg.Config(run=jcfg.RunConfig(
            trunk_parallel="tp")), m, params)
    except ValueError as e:
        want["indivisible"] = str(e)
    want["specs"] = {k: (jtp.tp_param_specs(p), p) for k, (_, p, _)
                     in jm.items() if k != "uni3d_odd"}
    got = collect(procs, tmp / "w2", timeout=300.0)
    got4 = collect(procs4, tmp / "w4", timeout=300.0)
    return want, {2: got, 4: got4}


def _ok(result):
    assert not (isinstance(result, dict) and "error" in result), \
        result.get("error")
    return result


def _port_names(tree) -> dict:
    """{port parameter name: (JAX leaf, whether it is a Dense kernel)} by
    `weights.from_jax_params`'s renames."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}

    def walk(node, path):
        bn = set(node) == {"mean", "var", "scale", "bias"}
        for name, val in node.items():
            if isinstance(val, dict) or hasattr(val, "items"):
                walk(val, path + [_module_name(name)])
                continue
            kernel = name == "kernel"
            leaf = "weight" if kernel or (name == "scale" and not bn) else name
            out[".".join(path + [leaf])] = (val, kernel)

    walk(tree, [])
    return out


@pytest.mark.parametrize("kind", ["uni3d", "ulip", "openshape"])
def test_tp_specs_follow_jax(runs, kind):
    """Every parameter's spec is JAX's (a kernel's transposed), the trunk
    sharded and the rest replicated, and each shard's shape at world 2 is
    JAX's on a 2-device mesh (transposed)."""
    want, got = runs
    jspecs, params = want["specs"][kind]
    jflat = _port_names(jspecs)
    shapes = _ok(got[2][0][f"forward_{kind}"])["shapes"]
    model = {"uni3d": lambda: uni3d.Uni3D(**UNI3D),
             "ulip": lambda: pointbert.ULIP(**ULIP),
             "openshape": lambda: ppta.Projected(
                 ppta.PPTAPreset(**PPTA), OUT, rel_pe=True)}[kind]()
    pspecs = tp.tp_param_specs(model)
    assert set(pspecs) == set(jflat) == set(shapes)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("model",))
    leaves = _port_names(params)
    n_sharded = 0
    for name, (spec, kernel) in jflat.items():
        spec = tuple(spec)
        spec = spec + (None,) * (leaves[name][0].ndim - len(spec))
        jshape = NamedSharding(mesh, P(*spec)).shard_shape(
            leaves[name][0].shape)
        if kernel:
            spec, jshape = spec[::-1], jshape[::-1]
        assert tuple(a for a in pspecs[name]) == tuple(
            a for a in spec[:len(pspecs[name])]), name
        assert all(a is None for a in spec[len(pspecs[name]):]), name
        assert shapes[name] == tuple(jshape), name
        n_sharded += any(a is not None for a in spec)
    # a block's q/k/v (5), proj, fc1_g/fc1_x (4), norm (2), fc2; or its
    # qkv, proj, fc1 (2), fc2
    assert n_sharded == (13 if kind == "uni3d" else 5) * 2
    for name in ("attn.q_norm.weight", "norm1.weight"):
        if kind == "uni3d":
            assert pspecs[f"point_encoder.blocks.0.{name}"] == ()


def test_tp_fused_qkv_is_per_head(runs):
    """ULIP's fused qkv: each rank of two holds its heads' columns of q, k
    and v (JAX's P(None, model) would cut [q|k|v] contiguously)."""
    want, got = runs
    _, params = want["specs"]["ulip"]
    full = np.asarray(params["params"]["point_encoder"]["blocks_0"]["attn"]
                      ["qkv"]["kernel"]).T                 # (3·64, 64)
    inner = ULIP["trans_dim"]
    for r in range(2):
        shard = _ok(got[2][r]["forward_ulip"])["params"][
            "point_encoder.blocks.0.attn.qkv.weight"]
        rows = np.concatenate([np.arange(b * inner + r * inner // 2,
                                         b * inner + (r + 1) * inner // 2)
                               for b in range(3)])
        np.testing.assert_array_equal(shard, full[rows])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["uni3d", "ulip", "openshape"])
def test_tp_forward_matches_jax_replicated(runs, kind, world):
    """Every rank's TP forward within 2e-5 of JAX's replicated forward,
    with exactly three sums a block of the EVA trunk and two a ViT
    block."""
    want, got = runs
    for r in range(world):
        res = _ok(got[world][r][f"forward_{kind}"])
        np.testing.assert_allclose(res["feat"], want[kind], rtol=TOL,
                                   atol=TOL)
        per_block = 3 if kind == "uni3d" else 2
        assert res["collectives"] == ["sum"] * per_block * 2


def test_tp_composes_with_data_axis(runs):
    """DP × TP on a 2 × 2 (data, model) grid: each data row encodes two of
    the four clouds, the model pairs sum their blocks, the features are
    gathered over the data axis; every rank's within 2e-5 of JAX's
    replicated forward."""
    want, got = runs
    for r in range(4):
        res = _ok(got[4][r]["dp_tp"])
        assert res["grid"] == (2, 2, r // 2, r % 2)
        np.testing.assert_allclose(res["feat"], want["dp"], rtol=TOL,
                                   atol=TOL)
        assert res["collectives"] == ["sum"] * 6 + ["gather"]


def test_tp_engine_step_trajectory_matches(runs):
    """The MODE-DOTA scan with residuals on the TP encoder at world 2, on
    tests/test_tp.py's weights, data and key (JAX's noise fed): every
    step's final logits within 1e-4 of JAX's replicated trajectory and of
    the port's own replicated one, `correct` equal."""
    want, got = runs
    outs = want["trajectory"]
    for r in range(2):
        res = _ok(got[2][r]["trajectory"])
        for logits, correct in ((np.asarray(outs.final_logits),
                                 np.asarray(outs.correct)),
                                (res["replicated"],
                                 res["replicated_correct"])):
            np.testing.assert_allclose(res["final_logits"], logits,
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_array_equal(res["correct"], correct)


@pytest.mark.parametrize("name", ["mode", "cache"])
def test_ep_tp_composition(runs, name):
    """EP × TP on a 2 × 2 (classes, model) grid: the class-sharded step of
    MODE-DOTA (residuals off, JAX's noise fed) or the cache with the trunk
    over each model pair; every rank's full-K state within rtol 2e-4, atol
    2e-5 of JAX's replicated run, acc@1 equal."""
    want, got = runs
    jstate, jouts = want[f"ep_{name}"]
    fields = (("mu", "var", "pi", "c", "class_counts") if name == "mode"
              else ("feats",))
    n_samples = T * (2 if name == "mode" else 1)
    for r in range(4):
        res = _ok(got[4][r][f"ep_tp_{name}"])
        for f in fields:
            np.testing.assert_allclose(
                res["state"][f], np.asarray(getattr(jstate.method_state, f)),
                rtol=2e-4, atol=2e-5, err_msg=f)
        if name == "cache":
            np.testing.assert_array_equal(
                res["state"]["valid"], np.asarray(jstate.method_state.valid))
        assert res["summary"]["n_class_shards"] == 2
        assert res["summary"]["acc1"] == pytest.approx(
            100.0 * int(np.asarray(jouts.correct)[:, 0].sum()) / n_samples)


def test_tp_indivisible_widths_raise_jax_error(runs):
    """A SwiGLU hidden width of 106 over four ranks raises the JAX CLI's
    error: the same text around the reason, the mesh's size the world's."""
    want, got = runs
    jax_text = want["indivisible"]
    for r in range(4):
        text = _ok({"r": got[4][r]["indivisible"]})["r"]
        assert text is not None
        pre, post = re.split(r" \(.*\)\)?\.  ", text, maxsplit=1)
        jpre, jpost = re.split(r" \(.*\)\)?\.  ", jax_text, maxsplit=1)
        assert pre == jpre.replace("8-device", "4-device")
        assert post == jpost
        assert "mlp.fc1_g.weight" in text and "106" in text
