"""OpenShape (PPTA) and ULIP-2 (Point-BERT) in the port against the JAX
package on the CPU: the weight mapping at the published widths, the
features and the MODE-DOTA engine at small widths, and the CLI.

The JAX side runs its kernel branches (FPS, kNN, ball query, the
natural-layout attention) in interpret mode; the port runs the kernels'
plain versions.  Head dims are multiples of 8 so that JAX's `ViTAttention`
takes its kernel path.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uni_adapter_tpu.ops.attention_pallas as attention_pallas
import uni_adapter_tpu.ops.ballquery_pallas as ballquery_pallas
import uni_adapter_tpu.ops.fps_pallas as fps_pallas
import uni_adapter_tpu.ops.knn_pallas as knn_pallas
from uni_adapter_tpu import config as jcfg_mod
from uni_adapter_tpu import engine as jengine
from uni_adapter_tpu.models import ppta as jppta
from uni_adapter_tpu.models.pointbert import create_ulip as jax_create_ulip
from uni_adapter_torch import config as pcfg_mod
from uni_adapter_torch import engine as pengine
from uni_adapter_torch.cli import tta
from uni_adapter_torch.models import ppta
from uni_adapter_torch.models.pointbert import ULIP, create_ulip
from uni_adapter_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401


#: OpenShape cut to a small width: dim 64, 2 layers of 2 heads of 64.
SMALL_PPTA = dict(dim=64, depth=2, heads=2, mlp_dim=128, sa_dim=32,
                  patches=16, prad=0.4, nsamp=8)
SMALL_ULIP = dict(ulip_trans_dim=64, ulip_depth=2, ulip_heads=4,
                  num_group=16, ulip_group_size=8, ulip_encoder_dim=32,
                  ulip_embed_dim=32)
OUT = 32                 # the small models' feature width


@pytest.fixture
def pallas_interpret(monkeypatch):
    for mod, name in ((fps_pallas, "fps_pallas_batched"),
                      (knn_pallas, "knn_pallas"),
                      (ballquery_pallas, "query_ball_pallas"),
                      (attention_pallas, "eva_attention_fused")):
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), interpret=True))


def perturbed_params(model, *example, seed=0):
    """flax init, then every leaf moved off its init value."""
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), *example)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
        .astype(np.float32), params)


def zero_tree(model, *example):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *example)
    return jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)


def jax_openshape(preset, out=OUT, dtype=jnp.float32):
    return jppta.Projected(preset=preset, out_channel=out,
                           use_pallas_fps=True, use_pallas_ballq=True,
                           use_pallas_attention=True, dtype=dtype)


def jax_ulip(**kw):
    return jax_create_ulip(jcfg_mod.ModelConfig(
        use_pallas_fps=True, use_pallas_knn=True, use_pallas_attention=True,
        compute_dtype="float32", **kw))


def port_openshape(state_dict):
    return ppta.create_openshape(
        pcfg_mod.ModelConfig(compute_dtype="float32", oshape_clip_dim=OUT),
        "cpu", preset=ppta.PPTAPreset(**SMALL_PPTA), state_dict=state_dict)


def port_ulip(state_dict):
    return create_ulip(pcfg_mod.ModelConfig(compute_dtype="float32",
                                            **SMALL_ULIP),
                       "cpu", state_dict=state_dict)


def _cloud(B, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32),
            rng.uniform(0, 1, (B, N, 3)).astype(np.float32))


def test_presets_are_the_jax_packages():
    assert {k: dataclasses.asdict(v) for k, v in ppta.PRESETS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jppta.PRESETS.items()}


def test_weight_mapping_covers_openshape_g_names_and_shapes():
    """At vit-G's widths (dim 512, 8 heads of 64, MLP 1536, set-abstraction
    MLP 9→64→64→256, proj to 1280; depth cut to 1), every flax leaf lands
    on a port parameter of the right shape."""
    preset = dataclasses.replace(jppta.PRESETS[4], depth=1)
    tree = zero_tree(jax_openshape(preset, out=1280),
                     jnp.zeros((1, 1024, 3)), jnp.zeros((1, 1024, 6)))
    mapped = {k: tuple(v.shape) for k, v in from_jax_params(tree).items()}
    with torch.device("meta"):
        port = ppta.Projected(dataclasses.replace(ppta.PRESETS[4], depth=1),
                              1280)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert mapped == want
    assert want["ppat.sa.conv0.weight"] == (64, 9)
    assert want["ppat.lift.weight"] == (512, 259)
    assert want["ppat.layers.0.attn.qkv.weight"] == (1536, 512)
    assert want["ppat.cls_token"] == (512,)
    assert want["proj.weight"] == (1280, 512)


def test_weight_mapping_covers_ulip_names_and_shapes():
    """At ULIP-2's widths (384, 6 heads, MLP 1536, 3-channel mini-PointNet;
    depth cut to 1): the bare pc_projection keeps its (768, 512) layout."""
    tree = zero_tree(jax_create_ulip(jcfg_mod.ModelConfig(ulip_depth=1)),
                     jnp.zeros((1, 1024, 3)))
    mapped = {k: tuple(v.shape) for k, v in from_jax_params(tree).items()}
    with torch.device("meta"):
        port = ULIP(depth=1)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert mapped == want
    assert want["pc_projection"] == (768, 512)
    assert want["point_encoder.encoder.conv1.weight"] == (128, 3)
    assert want["point_encoder.blocks.0.attn.qkv.weight"] == (1152, 384)
    assert want["point_encoder.blocks.0.mlp.fc1.weight"] == (1536, 384)


def test_openshape_features_match_jax(pallas_interpret):
    """fp32, 2 layers at width 64: features within 1e-4 (the same
    arithmetic summed in other orders; FPS and ball-query indices are
    exact)."""
    model = jax_openshape(jppta.PPTAPreset(**SMALL_PPTA))
    xyz, rgb = _cloud(2, 128, seed=1)
    feats = np.concatenate([xyz, rgb], -1)
    params = perturbed_params(model, jnp.asarray(xyz), jnp.asarray(feats))
    want = np.asarray(model.apply(params, jnp.asarray(xyz),
                                  jnp.asarray(feats)))
    port = port_openshape(from_jax_params(params))
    assert port.proj.weight.dtype == torch.float32
    with torch.no_grad():
        got = port(torch.from_numpy(xyz), torch.from_numpy(feats))
    assert got.dtype == torch.float32 and got.shape == (2, OUT)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_ulip_features_match_jax(pallas_interpret):
    """fp32, 2 blocks at width 64 (4 heads of 16): features within 1e-4."""
    model = jax_ulip(**SMALL_ULIP)
    xyz, _ = _cloud(2, 128, seed=2)
    params = perturbed_params(model, jnp.asarray(xyz))
    want = np.asarray(model.apply(params, jnp.asarray(xyz)))
    port = port_ulip(from_jax_params(params))
    with torch.no_grad():
        got = port(torch.from_numpy(xyz))
    assert got.dtype == torch.float32 and got.shape == (2, OUT)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_random_init_is_seeded_and_keeps_the_fp32_heads():
    """bf16 models: the Dense layers in bf16 except OpenShape's proj; the
    bare parameters and ULIP's pc_projection in fp32; the same seed gives
    the same weights."""
    cfg = pcfg_mod.ModelConfig(oshape_clip_dim=OUT, **SMALL_ULIP)
    small = ppta.PPTAPreset(**SMALL_PPTA)
    a = ppta.create_openshape(cfg, "cpu", seed=3, preset=small)
    b = ppta.create_openshape(cfg, "cpu", seed=3, preset=small)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert a.ppat.lift.weight.dtype == torch.bfloat16
    assert a.proj.weight.dtype == torch.float32
    assert a.ppat.cls_token.std() > 0.5          # normal(1.0), as in flax
    u = create_ulip(cfg, "cpu", seed=3)
    assert u.point_encoder.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert u.pc_projection.dtype == torch.float32
    assert 0.01 < u.pc_projection.std() < 0.03   # normal(0.02)
    assert not u.point_encoder.cls_token.any()
    assert not any(p.requires_grad for p in u.parameters()) and not u.training


def test_vit_attention_raises_on_unported_branches():
    """Every branch is ported now: a mask (the CLIP text tower; held
    against JAX in tests/test_torch_text.py), an attention bias
    (tests/test_torch_openshape_rest.py), `return_attn` and head dims that
    are not a multiple of 8 (tests/test_torch_attention_maps.py).  A zero
    mask gives what a zero bias gives on the same plain route (bitwise),
    and a causal one leaves the first token attending to itself alone."""
    from uni_adapter_torch.models.common import ViTAttention
    gen = torch.Generator().manual_seed(0)
    attn = ViTAttention(48, 2).float()
    for p in attn.parameters():
        torch.nn.init.normal_(p, std=0.2, generator=gen)
    x = torch.randn(1, 5, 48, generator=gen)
    with torch.no_grad():
        plain = attn(x, attn_bias=torch.zeros(1, 2, 5, 5))
        zero = attn(x, mask=torch.zeros(5, 5))
        causal = torch.full((5, 5), float("-inf")).triu(1)
        out, maps = attn(x, mask=causal, return_attn=True)
    torch.testing.assert_close(zero, plain, rtol=0, atol=0)
    assert maps[0, :, 0, 0].eq(1).all() and maps[0, :, 0, 1:].eq(0).all()
    assert torch.isfinite(out).all() and out.shape == (1, 5, 48)


def _both_engines(kind):
    """The same small backbone and MODE-DOTA config (no residuals) in both
    packages."""
    jmc = dict(vlm3d=kind, compute_dtype="float32")
    if kind == "openshape":
        jmodel = jax_openshape(jppta.PPTAPreset(**SMALL_PPTA))
        example = (jnp.zeros((1, 128, 3)), jnp.zeros((1, 128, 6)))
    else:
        jmodel = jax_ulip(**SMALL_ULIP)
        jmc.update(SMALL_ULIP)
        example = (jnp.zeros((1, 128, 3)),)
    jcfg = jcfg_mod.Config(model=jcfg_mod.ModelConfig(**jmc),
                           dota=jcfg_mod.DotaConfig(res_learning=False))
    pcfg = pcfg_mod.Config(model=pcfg_mod.ModelConfig(vlm3d=kind),
                           dota=pcfg_mod.DotaConfig(res_learning=False))
    params = perturbed_params(jmodel, *example, seed=4)
    sd = from_jax_params(params)
    pmodel = port_openshape(sd) if kind == "openshape" else port_ulip(sd)
    text = np.random.default_rng(5).standard_normal((10, OUT))
    text = (text / np.linalg.norm(text, axis=1, keepdims=True)).astype(
        np.float32)
    return jcfg, pcfg, jmodel, params, pmodel, text


@pytest.mark.parametrize("kind", ["openshape", "ulip"])
def test_engine_matches_step_for_step(pallas_interpret, kind):
    """5 steps, res_learning off, the JAX step's noise handed to the port:
    final and CLIP logits within atol 1e-3 (logits are 100·cosine),
    identical correct counts, and the same summary."""
    jcfg, pcfg, jmodel, params, pmodel, text = _both_engines(kind)
    jstep = jax.jit(jengine.make_step_fn(jcfg, jmodel))
    pstep = pengine.make_step_fn(pcfg, pmodel)
    js = jengine.init_state(jcfg, jnp.asarray(text), jax.random.PRNGKey(42))
    ps = pengine.init_state(pcfg, torch.from_numpy(text))
    rng = np.random.default_rng(6)
    jouts, pouts = [], []
    for _ in range(5):
        pc, rgb = _cloud(1, 128, seed=int(rng.integers(1 << 30)))
        target = rng.integers(0, 10, (1,)).astype(np.int32)
        noise = jax.random.normal(jax.random.split(js.rng)[1], pc.shape,
                                  jnp.float32)
        js, jout = jstep(params, jnp.asarray(text), js,
                         (jnp.asarray(pc), jnp.asarray(rgb),
                          jnp.asarray(target)))
        ps, pout = pstep(torch.from_numpy(text), ps,
                         tuple(torch.from_numpy(a) for a in (pc, rgb, target)),
                         noise=torch.from_numpy(np.array(noise)))
        jouts.append(jout)
        pouts.append(pout)
        for name in ("final_logits", "clip_logits"):
            np.testing.assert_allclose(getattr(pout, name).numpy(),
                                       np.asarray(getattr(jout, name)),
                                       atol=1e-3, err_msg=name)
        for name in ("correct", "zs_correct"):
            np.testing.assert_array_equal(getattr(pout, name).numpy(),
                                          np.asarray(getattr(jout, name)))
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jouts)
    assert pengine.summarize(pouts, 5) == jengine.summarize(stacked, 5)


@pytest.fixture
def stream_dir(tmp_path):
    """4 synthetic clouds × 128 points and their labels."""
    rng = np.random.default_rng(0)
    np.save(tmp_path / "data_uniform_5.npy",
            rng.uniform(-0.5, 0.5, (4, 128, 3)).astype(np.float32))
    np.save(tmp_path / "label.npy", rng.integers(0, 40, (4,)).astype(np.int64))
    return tmp_path


def _bank(path, width):
    bank = np.random.default_rng(width).standard_normal((40, width))
    np.save(path, (bank / np.linalg.norm(bank, axis=1, keepdims=True))
            .astype(np.float32))
    return str(path)


@pytest.mark.parametrize("flags,width", [
    # OpenShape vit-L (128 patches of 128 points, 12 layers) on 128 points
    (["--vlm3d", "openshape", "--oshape-version", "vitl14"], 768),
    (["--vlm3d", "ulip", *(f"--{k.replace('_', '-')}={v}"
                           for k, v in SMALL_ULIP.items())], OUT),
], ids=["openshape", "ulip"])
def test_cli_on_cpu_runs_each_backbone_with_a_bank_file(stream_dir, tmp_path,
                                                        flags, width):
    summary = tta.main(["--device", "cpu", "--root", str(stream_dir),
                        "--corruption", "uniform", "--npoints", "128",
                        "--compute-dtype", "float32",
                        "--precomputed-text-features",
                        _bank(tmp_path / "bank.npy", width),
                        "--output-dir", str(tmp_path / "out"),
                        "--name", "run", *flags])
    for name in ("results.json", "results_zs.json"):
        res = json.loads((tmp_path / "out" / "run" / name).read_text())
        assert set(res) == {"uniform"} and 0.0 <= res["uniform"] <= 100.0
    assert len(summary["step_ms"]["uniform"]) == 4
    assert summary["finite"]["uniform"]


def test_cli_rejects_a_bank_of_another_width(stream_dir, tmp_path):
    with pytest.raises(ValueError, match="512-d features"):
        tta.main(["--device", "cpu", "--root", str(stream_dir),
                  "--corruption", "uniform", "--vlm3d", "ulip",
                  "--ulip-depth", "1", "--precomputed-text-features",
                  _bank(tmp_path / "bank.npy", 1280),
                  "--output-dir", str(tmp_path / "out")])
