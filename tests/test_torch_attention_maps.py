"""The attention-map extraction path of the port against the JAX package
on the CPU: the (B, H, N, hd) attention (`ops/attention_heads.py`) against
the Pallas `attention_pallas_heads`, `return_attn` through all three
backbones, `ViTAttention` at a head dim that is not a multiple of 8, the
extractor, the statistics and the CLI.

The JAX side runs its kernel branches (FPS, kNN, ball query, the attention
block, the natural-layout and the (B, H, N, hd) attention) in interpret
mode; the port runs the kernels' plain versions.  Inputs and weight
perturbations come from numpy seeds.
"""
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uni_adapter_tpu.ops.attention_pallas as attention_pallas
import uni_adapter_tpu.ops.ballquery_pallas as ballquery_pallas
import uni_adapter_tpu.ops.fps_pallas as fps_pallas
import uni_adapter_tpu.ops.knn_pallas as knn_pallas
from uni_adapter_tpu.analysis import attention as jA
from uni_adapter_tpu.config import ModelConfig as JaxModelConfig
from uni_adapter_tpu.models import common as jcommon
from uni_adapter_tpu.models import ppta as jppta
from uni_adapter_tpu.models.pointbert import create_ulip as jax_create_ulip
from uni_adapter_tpu.models.uni3d import create_uni3d as jax_create_uni3d
from uni_adapter_torch.analysis import attention as pA
from uni_adapter_torch.cli import extract_attention
from uni_adapter_torch.config import ModelConfig
from uni_adapter_torch.models import common, ppta
from uni_adapter_torch.models.pointbert import create_ulip
from uni_adapter_torch.models.uni3d import create_uni3d
from uni_adapter_torch.ops.attention_heads import (attention_heads,
                                                   attention_heads_plain)
from uni_adapter_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401


#: Uni3D at width 64 (4 heads of 16), 2 blocks, 16 groups of 8.
SMALL_UNI3D = dict(pc_feat_dim=64, embed_dim=32, num_group=16, group_size=8,
                   pc_encoder_dim=32, eva_depth=2, eva_heads=4)
#: ULIP-2 at width 64 (4 heads of 16), 2 blocks.
SMALL_ULIP = dict(ulip_trans_dim=64, ulip_depth=2, ulip_heads=4,
                  num_group=16, ulip_group_size=8, ulip_encoder_dim=32,
                  ulip_embed_dim=32)
#: OpenShape at dim 64, 2 layers of 2 heads of 64.
SMALL_PPTA = dict(dim=64, depth=2, heads=2, mlp_dim=128, sa_dim=32,
                  patches=16, prad=0.4, nsamp=8)
OUT = 32


@pytest.fixture
def pallas_interpret(monkeypatch):
    for mod, name in ((fps_pallas, "fps_pallas_batched"),
                      (knn_pallas, "knn_pallas"),
                      (ballquery_pallas, "query_ball_pallas"),
                      (attention_pallas, "eva_attn_block_fused"),
                      (attention_pallas, "eva_attention_fused"),
                      (attention_pallas, "attention_pallas_heads")):
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), interpret=True))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# --------------------------------------------------------------------------
# ops/attention_heads.py against attention_pallas_heads
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,rtol,atol", [
    # fp32: the same arithmetic in another summation order
    ("float32", 1e-4, 1e-5),
    # bf16: a last-bit difference in a score can flip a bf16 rounding of p
    ("bfloat16", 2e-2, 2e-2),
])
@pytest.mark.parametrize("B,H,N,hd", [
    (2, 3, 70, 32), (1, 2, 128, 64), (3, 4, 77, 16),
    # the card's attention core at its edges: one key, one whole 64-key
    # chunk, one key past it, a last chunk of one key after 32 full ones
    # (hd 128, its widest variant), and several batches at 513 tokens
    (1, 1, 1, 128), (1, 2, 64, 128), (1, 2, 65, 128), (1, 2, 2049, 128),
    (8, 2, 513, 64)])
def test_attention_heads_matches_pallas_kernel(B, H, N, hd, dtype, rtol,
                                               atol):
    """The oracle shapes of tests/test_attention_pallas.py, and the edge
    shapes at which chip_smoke.py holds the card's kernel against this
    plain version."""
    q, k, v = (_rand((B, H, N, hd), seed=N + hd + i) for i in range(3))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = attention_pallas.attention_pallas_heads(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), interpret=True)
    got = attention_heads(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    assert got.dtype == tdt and got.shape == (B, H, N, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def test_attention_heads_uniformly_negative_scores_no_nan():
    """Every real score far below zero (q·k ≈ −200·|q|²): the maximum over
    the real keys keeps the row sum away from 0 (the Pallas kernel's
    underflow regression)."""
    q = _rand((1, 2, 33, 16), seed=5)
    v = _rand((1, 2, 33, 16), seed=6)
    want = attention_pallas.attention_pallas_heads(
        jnp.asarray(q), jnp.asarray(-200.0 * q), jnp.asarray(v),
        interpret=True)
    got = attention_heads_plain(torch.from_numpy(q),
                                torch.from_numpy(-200.0 * q),
                                torch.from_numpy(v)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# return_attn through the three backbones
# --------------------------------------------------------------------------

def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
        .astype(np.float32), params)


def _cloud(B, N, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-0.5, 0.5, (B, N, 3)),
                           rng.uniform(0, 1, (B, N, 3))], -1).astype(np.float32)


def _both(kind, dtype="float32", seed=0):
    """The JAX backbone on its kernel branches, its perturbed params, and
    the port's on the same weights; plus where the tokens sit, (num_group,
    group_size): 16 groups (or patches) of 8 in all three small models."""
    jdt = jnp.dtype(dtype)
    if kind == "uni3d":
        jmodel = jax_create_uni3d(JaxModelConfig(
            use_pallas_fps=True, use_pallas_knn=True,
            use_pallas_attention=True, use_pallas_attn_block=True,
            compute_dtype=dtype, **SMALL_UNI3D))
        example = (jnp.zeros((1, 128, 6)),)
        build = lambda sd: create_uni3d(
            ModelConfig(compute_dtype=dtype, **SMALL_UNI3D), "cpu",
            state_dict=sd)
    elif kind == "ulip":
        jmodel = jax_create_ulip(JaxModelConfig(
            use_pallas_fps=True, use_pallas_knn=True,
            use_pallas_attention=True, compute_dtype=dtype, **SMALL_ULIP))
        example = (jnp.zeros((1, 128, 3)),)
        build = lambda sd: create_ulip(
            ModelConfig(compute_dtype=dtype, **SMALL_ULIP), "cpu",
            state_dict=sd)
    else:
        preset = jppta.PPTAPreset(**SMALL_PPTA)
        jmodel = jppta.Projected(preset=preset, out_channel=OUT,
                                 use_pallas_fps=True, use_pallas_ballq=True,
                                 use_pallas_attention=True, dtype=jdt)
        example = (jnp.zeros((1, 128, 3)), jnp.zeros((1, 128, 6)))
        build = lambda sd: ppta.create_openshape(
            ModelConfig(compute_dtype=dtype, oshape_clip_dim=OUT), "cpu",
            preset=ppta.PPTAPreset(**SMALL_PPTA), state_dict=sd)
    params = _perturbed(jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                             *example), seed)
    return jmodel, params, build(from_jax_params(params)), (16, 8)


def _inputs(kind, pc):
    return (pc,) if kind == "uni3d" else \
        (pc[..., :3],) if kind == "ulip" else (pc[..., :3], pc)


@pytest.mark.parametrize("kind", ["uni3d", "ulip", "openshape"])
def test_return_attn_matches_jax(pallas_interpret, kind):
    """fp32 at small widths: features within 1e-4 (the same arithmetic in
    other orders), every map within 1e-5, and the features equal to the
    forward without maps (up to the attention kernel's summation order)."""
    jmodel, params, port, _ = _both(kind)
    pc = _cloud(2, 128, seed=7)
    want_f, want_maps = jmodel.apply(params, *_inputs(kind, jnp.asarray(pc)),
                                     return_attn=True)
    with torch.no_grad():
        got_f, got_maps = port(*_inputs(kind, torch.from_numpy(pc)),
                               return_attn=True)
        plain_f = port(*_inputs(kind, torch.from_numpy(pc)))
    assert got_f.dtype == torch.float32 and got_f.shape == (2, OUT)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_f.numpy(), plain_f.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert len(got_maps) == len(want_maps) == 2
    for g, w in zip(got_maps, want_maps):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def test_return_attn_bf16_matches_jax(pallas_interpret):
    """Uni3D in bf16: the block output from the (B, H, N, hd) attention
    (fp32 scores, bf16 p), the map from bf16-stored logits and an fp32
    softmax, as in the JAX package.  Envelope: both sides round to bf16 at
    the same points but sum in other orders, so a last-bit difference can
    flip a bf16 rounding upstream of a logit; features within rtol and
    atol 2e-2 (values up to ~2.5; max |Δ| 0.016 at this input, 0.023 at
    others), maps within 1e-2 (max |Δ| 0.004) and every row summing to 1."""
    jmodel, params, port, _ = _both("uni3d", dtype="bfloat16")
    pc = _cloud(2, 128, seed=8)
    want_f, want_maps = jmodel.apply(params, jnp.asarray(pc),
                                     return_attn=True)
    with torch.no_grad():
        got_f, got_maps = port(torch.from_numpy(pc), return_attn=True)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=2e-2,
                               atol=2e-2)
    for g, w in zip(got_maps, want_maps):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-2)
        np.testing.assert_allclose(g.sum(-1).numpy(), 1.0, atol=1e-5)


def test_return_attn_openshape_needs_the_global_cache_type():
    """`return_attn` raises on the `local` cache type, which runs without
    it (tests/test_torch_openshape_rest.py holds it against JAX)."""
    model = ppta.Projected(ppta.PPTAPreset(**SMALL_PPTA), OUT,
                           dtype=torch.float32, cache_type="local")
    xyz = torch.rand(1, 64, 3, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="cache_type='global'"):
        model(xyz, torch.zeros(1, 64, 6), return_attn=True)
    with torch.no_grad():
        assert model(xyz, torch.zeros(1, 64, 6)).shape == (5, OUT)


@pytest.mark.parametrize("return_attn", [False, True])
def test_vit_attention_head_dim_12_matches_jax(pallas_interpret, return_attn):
    """ViTAttention(36, 3): a head dim of 12 takes the (B, H, N, hd)
    attention in both packages (JAX `use_pallas=True`), fp32 within 1e-5."""
    jm = jcommon.ViTAttention(36, 3, use_pallas=True, dtype=jnp.float32)
    x = _rand((2, 21, 36), seed=9)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    want = jm.apply(params, jnp.asarray(x), return_attn=return_attn)
    port = common.ViTAttention(36, 3)
    port.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x), return_attn=return_attn)
    if not return_attn:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# --------------------------------------------------------------------------
# the extractor and the statistics
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["uni3d", "ulip", "openshape"])
def test_extractor_matches_jax(pallas_interpret, kind):
    """On mapped weights, one xyz-only cloud (ones as colour): every map
    within 1e-5, the CLS getters alike, the group centres exactly."""
    jmodel, params, port, (G, M) = _both(kind, seed=2)
    pc = _rand((128, 3), seed=10)
    jx = jA.AttentionExtractor(jmodel, params, G, M, vlm3d=kind)
    px = pA.AttentionExtractor(port, G, M, vlm3d=kind)
    want, got = jx.extract(pc), px.extract(pc)
    assert list(got) == list(want) == ["layer_0", "layer_1"]
    for key in want:
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5)
    for getter in ("get_cls_attention", "get_attention_to_cls"):
        for layer in (0, -1):
            np.testing.assert_allclose(getattr(px, getter)(layer),
                                       getattr(jx, getter)(layer), rtol=0,
                                       atol=1e-5)
    np.testing.assert_array_equal(px.get_group_centers(pc),
                                  jx.get_group_centers(pc))


def test_statistics_match_jax():
    """The numpy statistics on the same maps: exactly the JAX package's."""
    rng = np.random.default_rng(11)
    maps = {}
    for i in range(3):
        a = rng.uniform(size=(2, 3, 9, 9)).astype(np.float32) ** 4
        maps[f"layer_{i}"] = a / a.sum(-1, keepdims=True)
    attn = maps["layer_1"]
    np.testing.assert_array_equal(pA.attention_entropy(attn),
                                  jA.attention_entropy(attn))
    np.testing.assert_array_equal(pA.attention_sparsity(attn, 0.05),
                                  jA.attention_sparsity(attn, 0.05))
    np.testing.assert_array_equal(pA.cls_attention_evolution(maps),
                                  jA.cls_attention_evolution(maps))
    assert pA.attention_statistics(maps) == jA.attention_statistics(maps)
    got, want = pA._per_layer_stats(maps), jA._per_layer_stats(maps)
    np.testing.assert_array_equal(got.pop("cls_rows"), want.pop("cls_rows"))
    assert got == want


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

#: What `uni_adapter_tpu/cli/extract_attention.py::main` writes: its log,
#: figures (plotly absent: the PNG and canvas-HTML fallbacks), statistics
#: and maps.
JAX_CLI_FILES = {
    "extract.log", "attention_maps.png", "head_averaged.png",
    "cls_evolution.png", "per_head_grid.png", "layer_evolution.png",
    "attention_3d.html", "attention_on_pointcloud.html",
    "attention_heads_on_pointcloud.png", "layer_attention_grid.png",
    "attention_stats.json", "attention_maps.npz"}


def test_cli_on_cpu_writes_every_file_of_the_jax_cli(tmp_path, monkeypatch):
    """Uni3D at full width, depth 2, on the synthetic sphere, plotly absent
    (made so: other test files may leave a stub `plotly` module behind)."""
    for name in ("plotly", "plotly.graph_objects", "plotly.subplots"):
        monkeypatch.setitem(sys.modules, name, None)
    out = tmp_path / "attn"
    extract_attention.main(["--device", "cpu", "--vlm3d", "uni3d",
                            "--depth", "2", "--out", str(out)])
    assert {p.name for p in out.iterdir()} == JAX_CLI_FILES
    maps = np.load(out / "attention_maps.npz")
    assert sorted(maps.files) == ["layer_0", "layer_1"]
    for key in maps.files:
        a = maps[key]
        assert a.shape == (1, 16, 513, 513) and a.dtype == np.float32
        np.testing.assert_allclose(a.sum(-1), 1.0, atol=1e-3)
    stats = json.loads((out / "attention_stats.json").read_text())
    assert stats == pA.attention_statistics(dict(maps))


def test_cli_without_gpu_and_without_device_cpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="--device cpu"):
        extract_attention.main(["--depth", "1", "--out", str(tmp_path)])


def test_cli_checkpoint_is_not_ported(tmp_path):
    """`--checkpoint` is ported (tests/test_torch_loader.py holds its maps
    against the JAX CLI's); a path that does not exist raises."""
    with pytest.raises(FileNotFoundError):
        extract_attention.main(["--device", "cpu", "--checkpoint",
                                str(tmp_path / "x.pt"), "--out",
                                str(tmp_path)])


def test_cli_reads_a_sample_from_root(tmp_path):
    """`--root`: the sample comes from the port's ModelNet40-C loader
    (ULIP-2 at full width, 12 blocks, on one 1024-point cloud)."""
    rng = np.random.default_rng(12)
    np.save(tmp_path / "data_uniform_5.npy",
            rng.standard_normal((2, 1024, 3)).astype(np.float32))
    np.save(tmp_path / "label.npy", np.array([3, 7]))
    args = extract_attention.parse_args(
        ["--device", "cpu", "--vlm3d", "ulip", "--root", str(tmp_path),
         "--sample-idx", "1", "--out", str(tmp_path / "out")])
    _, pc, maps = extract_attention.extract(args)
    np.testing.assert_array_equal(pc, np.load(tmp_path /
                                              "data_uniform_5.npy")[1])
    assert len(maps) == 12 and maps["layer_0"].shape == (1, 6, 513, 513)
    assert (tmp_path / "out" / "attention_maps.npz").exists()


def test_build_backbone_gives_the_token_grouping():
    """Where the tokens sit: OpenShape's set-abstraction FPS centres (vit-L:
    128 patches of 128 points), ULIP-2's groups (512 of 32)."""
    from uni_adapter_torch.models.loader import build_backbone
    _, G, M = build_backbone("openshape", ModelConfig(
        vlm3d="openshape", oshape_version="vitl14"), "cpu")
    assert (G, M) == (ppta.PRESETS[3].patches, ppta.PRESETS[3].nsamp)
    model, G, M = build_backbone("ulip", ModelConfig(ulip_depth=1), "cpu")
    assert (G, M) == (512, 32) and len(model.point_encoder.blocks) == 1
    with pytest.raises(ValueError, match="unknown vlm3d"):
        build_backbone("pointnet", ModelConfig(), "cpu")
