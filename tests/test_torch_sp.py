"""The port's sequence-parallel trunk (`parallel/sp.py`, exact ring
attention) over torch.distributed against the JAX package on its CPU
mesh, at the small dims of tests/test_sp.py (Uni3D and ULIP-2 width 48,
4 heads, depth 4; fp32, and Uni3D in bf16).

The port's worlds of two and four ranks are processes over gloo, spawned
once for the module (`torch_dist_worker.py`, program `sp`), which run
every case on a (data, seq) grid of their world and hand back their
results while JAX runs its side.  JAX's own tests hold its SP forwards to
its plain forward within 1e-5 on an 8-device mesh; the port is held to
JAX's plain forwards, its single-device train step and its scan's
`correct`, at worlds of 2 and 4:

  * ring attention within rtol 2e-5 of dense attention (float64) on an
    exact split, a padded one and a split whose last shard is all
    padding (9 tokens over 4 ranks), its gradients through the reverse
    shifts too;
  * forwards within rtol/atol 1e-5 of JAX's plain forward, 17 tokens at
    2 and 4 ranks and 16 at 4, SP × DP on 2 × 2; bf16 within JAX's 0.05
    of the port's plain bf16 forward;
  * two AdamW steps at world 4 (the first at lr 0 under warmup) against
    JAX's single-device steps, the loss within rtol 1e-5, the parameters
    within tests/test_torch_pp.py's `PARAM_ATOL` (the k LayerNorm's
    bias, whose exact gradient is 0, within `NOISE_ATOL`), on SP alone
    and on SP × DP;
  * the MODE-DOTA scan with residuals through `encode_fn`: logits within
    1e-4 of the port's replicated run, `correct` equal to JAX's;
  * a hop is one packed K ‖ V ‖ mask buffer, depth·(S − 1) of them a
    forward, then the gather;
  * the int8 trunk and OpenShape raise JAX's ValueErrors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from test_torch_pp import (METRIC_RTOL, NOISE_ATOL, OPTIMIZER, PARAM_ATOL,
                           _dota_configs, _jax_train, _text, drawn_params)
from test_torch_tp import key_noise
from torch_dist_worker import build_pp_model, collect, start_world
from uni_adapter_tpu import engine as jengine
from uni_adapter_tpu.models.pointbert import ULIP as JULIP
from uni_adapter_tpu.models.uni3d import Uni3D as JUni3D
from uni_adapter_tpu.parallel import sp as jsp
from uni_adapter_torch import engine
from uni_adapter_torch.parallel import sp
from uni_adapter_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

UNI3D = dict(trans_dim=48, embed_dim=32, group_size=8, encoder_dim=24,
             num_heads=4, depth=4)
ULIP = dict(trans_dim=48, num_heads=4, num_group=16, group_size=8,
            encoder_dim=24, embed_dim=32, depth=4)
K, N, T = 5, 64, 4
TOL = 1e-5

#: the forwards: name -> (world, model, inputs, S, dp)
FORWARDS = {
    "uni3d_2_17": (2, "u4", "pc", 2, 1),
    "uni3d_4_17": (4, "u4", "pc", 4, 1),
    "uni3d_4_16": (4, "u4_15", "pc", 4, 1),
    "ulip_2": (2, "l4", "pts", 2, 1),
    "ulip_4": (4, "l4", "pts", 4, 1),
    "dp": (4, "u4", "pc", 2, 2),
    "bf16": (2, "u4_bf16", "pc2", 2, 1),
}
#: ring attention: name -> (world, tokens)
RINGS = {"exact": (4, 16), "padded": (2, 19), "all_padding": (4, 9)}


def _dense(q, k, v, scale):
    s = np.einsum("bhnd,bhmd->bhnm", q, k) * scale
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    return np.einsum("bhnm,bhmd->bhnd", p / p.sum(axis=-1, keepdims=True), v)


def _jax_models():
    """{name: (JAX module, params, port kind, port dims, dtype)}."""
    z6, z3 = jnp.zeros((1, N, 6)), jnp.zeros((1, N, 3))
    out = {}
    m = JUni3D(**UNI3D, num_group=16, dtype=jnp.float32)
    out["u4"] = (m, drawn_params(m, z6), "uni3d",
                 dict(UNI3D, num_group=16), "float32")
    # 15 groups: 16 tokens, the same parameter tree
    out["u4_15"] = (JUni3D(**UNI3D, num_group=15, dtype=jnp.float32),
                    out["u4"][1], "uni3d", dict(UNI3D, num_group=15),
                    "float32")
    out["u4_bf16"] = (None, out["u4"][1], "uni3d", dict(UNI3D, num_group=16),
                      "bfloat16")
    m = JULIP(**ULIP, dtype=jnp.float32)
    out["l4"] = (m, drawn_params(m, z3), "ulip", ULIP, "float32")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's worlds of two and four (spawned first), then JAX's
    forwards, train steps and trajectory."""
    tmp = tmp_path_factory.mktemp("sp")
    jm = _jax_models()
    rng = np.random.default_rng(0)
    xs = {"pc": rng.standard_normal((4, N, 6)).astype(np.float32),
          "pts": rng.standard_normal((4, N, 3)).astype(np.float32)}
    xs["pc2"] = xs["pc"][:2]
    batches = [(xs["pc"], rng.standard_normal((4, 32)).astype(np.float32),
                rng.standard_normal((4, 32)).astype(np.float32))
               for _ in range(2)]
    models = {k: (kind, dims, dt, from_jax_params(p))
              for k, (_, p, kind, dims, dt) in jm.items()}
    rings = {}
    for name, (world, n_tok) in RINGS.items():
        q, k, v, ct = (rng.standard_normal((2, 3, n_tok, 8)).astype(
            np.float32) for _ in range(4))
        rings[name] = dict(q=q, k=k, v=v, ct=ct, scale=8 ** -0.5)
    trng = np.random.default_rng(29)
    text = _text(trng, K)
    pcs = trng.standard_normal((T, 1, N, 3)).astype(np.float32)
    stream = (pcs, np.ones_like(pcs),
              trng.integers(0, K, (T, 1)).astype(np.int32))
    noise = key_noise(jax.random.PRNGKey(7), T, (1, N, 3))

    cases = [dict(name=f"ring_{n}", type="ring", world=w, **rings[n])
             for n, (w, _) in RINGS.items()]
    cases += [dict(name=f"fwd_{n}", type="forward", world=w, model=m,
                   inputs=(xs[x],), S=S, dp=dp, plain=n == "bf16")
              for n, (w, m, x, S, dp) in FORWARDS.items()]
    cases += [dict(name=f"train_{n}", type="train", world=4, model="u4",
                   S=S, dp=dp, optimizer=OPTIMIZER, batches=batches)
              for n, S, dp in (("sp", 4, 1), ("dp", 2, 2))]
    cases.append(dict(name="traj", type="trajectory", world=2, model="u4",
                      kind="uni3d", cfg=_dota_configs("uni3d")[1],
                      text=text, stream=stream, noise=noise))
    spec = {"models": models, "cases": cases}
    procs = {w: start_world("sp", spec, tmp / f"w{w}", world=w)
             for w in (2, 4)}

    want = {"rings": rings}
    for name in ("u4", "u4_15", "l4"):
        m, params = jm[name][:2]
        x = xs["pts" if name == "l4" else "pc"]
        want[name] = np.asarray(jax.jit(m.apply)(params, jnp.asarray(x)),
                                np.float32)
    want["train"] = _jax_train(jm["u4"][0], jm["u4"][1], batches, 1)
    jc = _dota_configs("uni3d")[0]
    m, params = jm["u4"][:2]
    _, outs = jax.jit(jengine.make_scan_fn(jc, m))(
        params, jnp.asarray(text), jengine.init_state(
            jc, jnp.asarray(text), jax.random.PRNGKey(7)),
        *(jnp.asarray(a) for a in stream))
    want["traj_correct"] = np.asarray(outs.correct)
    got = {w: collect(p, tmp / f"w{w}", timeout=300.0)
           for w, p in procs.items()}
    return want, got


def _ok(result):
    assert not (isinstance(result, dict) and "error" in result), \
        result.get("error")
    return result


def _forward(runs, name):
    want, got = runs
    w = FORWARDS[name][0]
    return [_ok(got[w][r][f"fwd_{name}"]) for r in range(w)], want


@pytest.mark.parametrize("name", list(RINGS))
def test_ring_attention_matches_dense(runs, name):
    """Each rank's rows of ring attention within rtol 2e-5 of dense
    attention over the real keys (float64), the parts form and the
    autograd form alike; exact, padded (the mask rides the ring) and a
    last shard of padding only (its first fold all masked, wiped by the
    next); S − 1 hops of one packed K ‖ V ‖ mask buffer each."""
    want, got = runs
    world, n_tok = RINGS[name]
    c = want["rings"][name]
    ref = _dense(*(c[k].astype(np.float64) for k in "qkv"), c["scale"])
    for r in range(world):
        res = _ok(got[world][r][f"ring_{name}"])
        lo, hi = res["rows"]
        real = slice(0, max(0, min(hi, n_tok) - lo))
        for out in (res["out"], res["autograd_out"]):
            np.testing.assert_allclose(out[:, :, real], ref[:, :, lo:hi],
                                       rtol=2e-5, atol=2e-6)
        n_loc = hi - lo
        packed = (2 * 2 * 3 * n_loc * 8 + n_loc) * 4
        assert res["log"] == [("shift", packed, (packed // 4,))] * (world - 1)


@pytest.mark.parametrize("name", list(RINGS))
def test_ring_attention_gradient_matches_dense(runs, name):
    """The autograd form's gradients of sum(out·ct) over the real query
    rows, gathered from the ranks' shards, within 1e-4 of dense
    attention's (float64 autograd): the reverse shifts carry each key
    block's cotangent back to its rank, and padded keys get none."""
    want, got = runs
    world, n_tok = RINGS[name]
    c = want["rings"][name]
    leaves = [torch.tensor(c[k], dtype=torch.float64, requires_grad=True)
              for k in "qkv"]
    q, k, v = leaves
    y = torch.softmax(q @ k.transpose(-1, -2) * c["scale"], -1) @ v
    ref = torch.autograd.grad((y * torch.from_numpy(c["ct"])).sum(), leaves)
    shards = [_ok(got[world][r][f"ring_{name}"])["grads"]
              for r in range(world)]
    for i in range(3):
        full = np.concatenate([s[i] for s in shards], axis=2)
        np.testing.assert_allclose(full[:, :, :n_tok], ref[i].numpy(),
                                   rtol=1e-4, atol=1e-5)
        assert not full[:, :, n_tok:].any()


@pytest.mark.parametrize("name", ["uni3d_2_17", "uni3d_4_17",
                                  "uni3d_4_16"])
def test_sp_uni3d_matches_plain_forward(runs, name):
    """Every rank's features within 1e-5 of JAX's plain forward: 17
    tokens padded to 18 and 20, 16 tokens split exactly over 4 ranks."""
    res, want = _forward(runs, name)
    for r in res:
        np.testing.assert_allclose(r["feat"], want[FORWARDS[name][1]],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["ulip_2", "ulip_4"])
def test_sp_ulip_matches_plain_forward(runs, name):
    """ULIP-2's positions sharded with the tokens and re-added every block;
    the padding sliced off before its head's max-pool."""
    res, want = _forward(runs, name)
    for r in res:
        np.testing.assert_allclose(r["feat"], want["l4"], rtol=TOL, atol=TOL)


def test_sp_dp_composition_matches_plain_forward(runs):
    """SP × DP on a 2 × 2 (data, seq) grid, rank = d·2 + s: each data rank
    runs its rows, each seq rank its tokens, the output gathered over
    both; within 1e-5 of the plain forward on every rank."""
    res, want = _forward(runs, "dp")
    for r, out in enumerate(res):
        assert out["grid"] == (2, 2, r % 2, r // 2)
        np.testing.assert_allclose(out["feat"], want["u4"], rtol=TOL,
                                   atol=TOL)
        assert [k for k, *_ in out["log"]][-2:] == ["gather", "gather"]


def test_sp_bf16_close_to_plain_forward(runs):
    """Under bf16 the ring keeps fp32 softmax state while the plain path
    rounds its logits: within JAX's 0.05 of the port's plain bf16
    forward."""
    res, _ = _forward(runs, "bf16")
    for r in res:
        np.testing.assert_allclose(r["feat"], r["plain"], rtol=0.05,
                                   atol=0.05)


@pytest.mark.parametrize("name", ["uni3d_2_17", "uni3d_4_16", "ulip_4"])
def test_sp_shifts_carry_packed_kv_only(runs, name):
    """A forward yields depth·(S − 1) shifts, each one packed (B, H, n_loc,
    hd) K ‖ V ‖ (n_loc,) mask buffer, then one gather of the shards."""
    res, _ = _forward(runs, name)
    S = FORWARDS[name][3]
    n_loc = -(-(16 if name == "uni3d_4_16" else 17) // S)
    packed = (2 * 4 * n_loc * 48 + n_loc) * 4
    for r in res:
        kinds = [k for k, *_ in r["log"]]
        assert kinds == ["shift"] * (4 * (S - 1)) + ["gather"]
        assert {b for k, b, _ in r["log"] if k == "shift"} == {packed}


@pytest.mark.parametrize("name", ["sp", "dp"])
def test_sp_train_step_matches_single_device(runs, name):
    """Two AdamW steps of the SP train step at world 4 (SP over 4 ranks;
    SP × DP on 2 × 2) against JAX's single-device steps: the metrics and
    the log-scale on every rank, every rank's parameters (replicated)."""
    want, got = runs
    jmetrics, jparams, jls = want["train"]
    for r in range(4):
        res = _ok(got[4][r][f"train_{name}"])
        for g, w in zip(res["metrics"], jmetrics):
            for k in ("loss", "pc_text_acc", "pc_image_acc"):
                np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL,
                                           err_msg=k)
        np.testing.assert_allclose(res["logit_scale"], jls, rtol=1e-6)
        assert set(res["params"]) == set(jparams)
        for n, p in res["params"].items():
            atol = NOISE_ATOL if "k_norm.bias" in n else PARAM_ATOL
            np.testing.assert_allclose(p, jparams[n].numpy(), rtol=1e-4,
                                       atol=atol, err_msg=n)


def test_sp_engine_step_trajectory_matches(runs):
    """The MODE-DOTA scan with residuals through the SP encoder at world 2
    (JAX's noise fed): final logits within 1e-4 of the port's replicated
    run, `correct` equal to it and to JAX's."""
    want, got = runs
    for r in range(2):
        res = _ok(got[2][r]["traj"])
        (logits, correct), (rep, rep_correct) = res["sp"], res["replicated"]
        np.testing.assert_allclose(logits, rep, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(correct, rep_correct)
        np.testing.assert_array_equal(correct, want["traj_correct"])


def test_sp_in_a_world_of_one_is_the_plain_forward():
    """Without a group the SP forward folds one key block and yields
    nothing: within 1e-5 of the plain forward."""
    jm = _jax_models()
    rng = np.random.default_rng(3)
    for name, x in (("u4", rng.standard_normal((2, N, 6))),
                    ("l4", rng.standard_normal((2, N, 3)))):
        model = build_pp_model(*(jm[name][i] for i in (2, 3, 4)),
                               from_jax_params(jm[name][1]))
        x = torch.from_numpy(x.astype(np.float32))
        parts = sp.make_sp_forward(model)(x)
        with torch.no_grad():
            with pytest.raises(StopIteration) as done:
                next(parts)
            np.testing.assert_allclose(done.value.value, model(x), rtol=TOL,
                                       atol=TOL)


def test_sp_rejects_int8_trunk():
    """JAX's ValueError text for an int8 trunk."""
    from uni_adapter_torch.models.uni3d import Uni3D

    mesh = Mesh(np.asarray(jax.devices()[:1]), ("seq",))
    with pytest.raises(ValueError, match="int8") as want:
        jsp.make_sp_forward_uni3d(JUni3D(**UNI3D, quantize=True), mesh)
    with pytest.raises(ValueError) as got:
        sp.make_sp_forward(Uni3D(**UNI3D, quantize=True))
    assert str(got.value) == str(want.value)


def test_sp_encode_rejects_openshape():
    """JAX's ValueError text for OpenShape's PPTA."""
    from uni_adapter_torch.models.uni3d import Uni3D

    mesh = Mesh(np.asarray(jax.devices()[:1]), ("seq",))
    with pytest.raises(ValueError, match="uni3d") as want:
        jsp.make_sp_encode_fn(JUni3D(**UNI3D), mesh, "openshape")
    with pytest.raises(ValueError) as got:
        sp.make_sp_encode_fn(Uni3D(**UNI3D), "openshape")
    assert str(got.value) == str(want.value)
