"""The port's checkpoint loader (`uni_adapter_torch/models/loader.py`)
against the JAX package's on the CPU.

The checkpoints are synthetic, written in the reference's published
layouts: by the JAX package's own torch twins (`test_weight_conversion`,
`test_converter_layouts`, imported, not edited) and by
`scripts/reference_layouts.py` from port models.  Each is converted by
both packages: the conversion reports must agree entry for entry (under
the flax names) and the loaded models' forwards within fp32 rounding.
Twins cover every parameter, so the two packages' different random inits
never meet, except where the missing list itself is the point.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from uni_adapter_tpu.models import loader as jloader
from uni_adapter_tpu.models.clip_text import TextEncoder as JaxTextEncoder
from uni_adapter_tpu.models.common import EvaBlock as JaxEvaBlock
from uni_adapter_tpu.models.pointbert import ULIP as JaxULIP
from uni_adapter_tpu.models.ppta import PPTAPreset as JaxPreset
from uni_adapter_tpu.models.ppta import Projected as JaxProjected
from uni_adapter_tpu.models.uni3d import Uni3D as JaxUni3D
from uni_adapter_torch.cli import extract_attention
from uni_adapter_torch.config import ModelConfig
from uni_adapter_torch.models import loader
from uni_adapter_torch.models.clip_text import create_text_encoder
from uni_adapter_torch.models.common import (BatchNormInference, EvaBlock,
                                             finish_model)
from uni_adapter_torch.models.pointbert import create_ulip
from uni_adapter_torch.models.ppta import PPTAPreset, create_openshape
from uni_adapter_torch.models.uni3d import create_uni3d
from scripts import reference_layouts
from test_converter_layouts import (DIM, HEADS, HID, PATCH, PD, PH, PMLP,
                                    PSA, NSAMP, TC, TE, TH, TL, TV, TW,
                                    OpenClipTextTwin, OpenShapeTwin,
                                    TimmFusedEvaBlock)
from test_weight_conversion import (DEPTH, EMBED, ENC, G, M, TRANS, UDEPTH,
                                    UEMB, UENC, UH, UT, TorchULIP,
                                    TorchUni3D)
from test_weight_conversion import HEADS as U3_HEADS
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
N_POINTS = 64
PPTA_PRESET = dict(dim=PD, depth=2, heads=PH, mlp_dim=PMLP, sa_dim=PSA,
                   patches=PATCH, prad=0.6, nsamp=NSAMP)


def _cloud(C: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, N_POINTS, C)) * 0.3).astype(np.float32)


def _uni3d_inputs():
    pc = _cloud(3, 0)
    return (np.concatenate([pc, np.ones_like(pc)], -1),)


def _openshape_inputs():
    xyz = _cloud(3, 3)
    return xyz, np.concatenate([xyz, np.ones_like(xyz)], -1)


def _text_inputs():
    toks = np.random.default_rng(1).integers(1, TV - 1, (3, TC)).astype(
        np.int32)
    toks[0, 5], toks[0, 6:] = TV - 1, 0       # EOT, then padding
    toks[1, -1] = TV - 1                      # EOT at the last slot
    return (toks,)                            # row 2: no EOT at all


def _port_uni3d(seed=5):
    return create_uni3d(ModelConfig(
        pc_feat_dim=TRANS, embed_dim=EMBED, num_group=G, group_size=M,
        pc_encoder_dim=ENC, eva_depth=DEPTH, eva_heads=U3_HEADS,
        compute_dtype="float32"), "cpu", seed=seed)


def _port_ulip(seed=5):
    return create_ulip(ModelConfig(
        ulip_trans_dim=UT, ulip_depth=UDEPTH, ulip_heads=UH, num_group=G,
        ulip_group_size=M, ulip_encoder_dim=UENC, ulip_embed_dim=UEMB,
        compute_dtype="float32"), "cpu", seed=seed)


def _port_openshape(seed=5):
    return create_openshape(ModelConfig(oshape_clip_dim=16,
                                        compute_dtype="float32"), "cpu",
                            seed=seed, preset=PPTAPreset(**PPTA_PRESET))


def _port_text(seed=5):
    return create_text_encoder("ulip", "cpu", torch.float32, seed=seed,
                               vocab_size=TV, width=TW, layers=TL, heads=TH,
                               context_length=TC, embed_dim=TE)


#: name → (torch twin, JAX model, port model, inputs).  The port models
#: come from seeds, so the overlay has to replace every parameter.
CASES = {
    "uni3d": (TorchUni3D,
              lambda: JaxUni3D(trans_dim=TRANS, embed_dim=EMBED, num_group=G,
                               group_size=M, encoder_dim=ENC, depth=DEPTH,
                               num_heads=U3_HEADS, dtype=jnp.float32),
              _port_uni3d, _uni3d_inputs),
    "ulip": (TorchULIP,
             lambda: JaxULIP(trans_dim=UT, depth=UDEPTH, num_heads=UH,
                             num_group=G, group_size=M, encoder_dim=UENC,
                             embed_dim=UEMB, dtype=jnp.float32),
             _port_ulip, lambda: (_cloud(3, 2),)),
    "eva_fused": (TimmFusedEvaBlock,
                  lambda: JaxEvaBlock(DIM, HEADS, mlp_ratio=HID / DIM,
                                      dtype=jnp.float32),
                  lambda: finish_model(
                      EvaBlock(DIM, HEADS, mlp_ratio=HID / DIM), "cpu",
                      torch.float32, 5, None, lambda gen: None),
                  lambda: (np.random.default_rng(0).standard_normal(
                      (2, 9, DIM)).astype(np.float32),)),
    "clip_text": (OpenClipTextTwin,
                  lambda: JaxTextEncoder(vocab_size=TV, width=TW, layers=TL,
                                         heads=TH, context_length=TC,
                                         embed_dim=TE, dtype=jnp.float32),
                  _port_text, _text_inputs),
    "openshape": (OpenShapeTwin,
                  lambda: JaxProjected(preset=JaxPreset(**PPTA_PRESET),
                                       out_channel=16, in_dim=6,
                                       dtype=jnp.float32),
                  _port_openshape, _openshape_inputs),
}


def _twin_checkpoint(twin_cls, path, seed=0) -> str:
    torch.manual_seed(seed)
    twin = twin_cls().eval()
    for mod in twin.modules():
        if isinstance(mod, (tnn.BatchNorm1d, tnn.BatchNorm2d)):
            mod.running_mean.normal_(0, 0.2)
            mod.running_var.uniform_(0.5, 1.5)
    torch.save({"module": {"module." + k: v
                           for k, v in twin.state_dict().items()}}, path)
    return str(path)


def _jax_report(jmodel, inputs, converted):
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  *[jnp.asarray(x) for x in inputs])
    return params, jloader.conversion_report(params, converted)


def _port_forward(model, inputs):
    with torch.no_grad():
        return model(*[torch.from_numpy(x) for x in inputs]).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_twin_checkpoint_gives_the_jax_report_and_forward(case, tmp_path):
    """Every published layout: the same report in both packages, CLEAN,
    and the same forward (fp32, rtol 1e-5, atol 1e-6)."""
    twin_cls, jax_model, port_model, inputs = CASES[case]
    path = _twin_checkpoint(twin_cls, tmp_path / f"{case}.pt")
    inputs = inputs()
    jconv = jloader.convert_state_dict(jloader.load_torch_state_dict(path))
    pconv = loader.convert_state_dict(loader.load_torch_state_dict(path))
    assert jconv.keys() == pconv.keys()
    for key in jconv:
        np.testing.assert_array_equal(jconv[key], pconv[key])
    jmodel = jax_model()
    params, want = _jax_report(jmodel, inputs, jconv)
    model = port_model()
    got = loader.overlay(model, pconv, strict=True)
    assert got == want
    assert not got["missing"] and not got["unexpected"]
    params = jloader.overlay_params(params, jconv, strict=True)
    expect = np.asarray(jax.jit(jmodel.apply)(params, *[jnp.asarray(x)
                                                        for x in inputs]))
    np.testing.assert_allclose(_port_forward(model, inputs), expect,
                               rtol=1e-5, atol=1e-6)


def test_partial_and_mismatched_checkpoints_report_as_jax(tmp_path):
    """A dropped key, a stray key and a wrong shape: JAX's missing,
    unexpected and shape-mismatch lists, entry for entry; the dropped and
    mismatched parameters keep their init, and strict raises."""
    path = _twin_checkpoint(TimmFusedEvaBlock, tmp_path / "eva.pt", seed=1)
    sd = loader.load_torch_state_dict(path)
    sd.pop("attn.proj.bias")
    sd.pop("norm2.weight")
    sd["stray.weight"] = np.zeros((3, 3), np.float32)
    sd["mlp.w3.weight"] = np.zeros((DIM, HID + 1), np.float32)
    _, jax_model, port_model, inputs = CASES["eva_fused"]
    _, want = _jax_report(jax_model(), inputs(),
                          jloader.convert_state_dict(sd))
    model = port_model()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    got = loader.overlay(model, loader.convert_state_dict(sd))
    assert got == want
    assert got["missing"] == ["params/attn/proj/bias", "params/mlp/fc2/kernel",
                              "params/norm2/scale"]
    assert got["unexpected"] == ["mlp/fc2/kernel", "stray/kernel"]
    assert got["shape_mismatches"] == [("params/mlp/fc2/kernel",
                                        "mlp/fc2/kernel", (HID, DIM),
                                        (HID + 1, DIM))]
    for name in ("attn.proj.bias", "mlp.fc2.weight", "norm2.weight"):
        torch.testing.assert_close(model.state_dict()[name], init[name],
                                   rtol=0, atol=0)
    assert not torch.equal(model.state_dict()["attn.q_proj.weight"],
                           init["attn.q_proj.weight"])
    with pytest.raises(ValueError, match="strict overlay failed"):
        loader.overlay(port_model(), loader.convert_state_dict(sd),
                       strict=True)


#: The reference-layout writer's models: port model → (JAX model, inputs).
WRITER_CASES = {
    "uni3d": (_port_uni3d, CASES["uni3d"][1], _uni3d_inputs),
    "ulip": (_port_ulip, CASES["ulip"][1], lambda: (_cloud(3, 2),)),
    "openshape": (_port_openshape, CASES["openshape"][1], _openshape_inputs),
    "clip_text": (_port_text, CASES["clip_text"][1], _text_inputs),
}


@pytest.mark.parametrize("layout", list(WRITER_CASES))
def test_reference_layout_writer_loads_clean_in_both_packages(layout,
                                                              tmp_path):
    """`scripts/reference_layouts.py` (what chip_smoke.py writes its
    checkpoints with): the JAX package's strict overlay takes the file,
    and the port's loader puts the source model's weights bitwise into a
    model from another seed, whose forward is then the source's bitwise
    and the JAX model's within fp32 rounding (rtol 1e-5, atol 1e-6)."""
    make, jax_model, inputs = WRITER_CASES[layout]
    src = make(seed=1)
    gen = torch.Generator().manual_seed(0)
    for mod in src.modules():        # BatchNorm statistics off their init
        if isinstance(mod, BatchNormInference):
            mod.mean.normal_(0, 0.2, generator=gen)
            mod.var.uniform_(0.5, 1.5, generator=gen)
    path = tmp_path / f"{layout}.pt"
    reference_layouts.save(reference_layouts.LAYOUTS[layout](src), path)
    inputs = inputs()
    jmodel = jax_model()
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  *[jnp.asarray(x) for x in inputs])
    jconv = jloader.convert_state_dict(jloader.load_torch_state_dict(path))
    params = jloader.overlay_params(params, jconv, strict=True)
    dst = make(seed=2)
    report = loader.load_checkpoint(dst, path, strict=True)
    assert len(report["converted"]) == report["n_model_leaves"]
    for (name, a), (_, b) in zip(src.state_dict().items(),
                                 dst.state_dict().items()):
        assert torch.equal(a, b), name
    got = _port_forward(dst, inputs)
    np.testing.assert_array_equal(got, _port_forward(src, inputs))
    np.testing.assert_allclose(
        got, np.asarray(jax.jit(jmodel.apply)(params, *[jnp.asarray(x)
                                                        for x in inputs])),
        rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def uni3d_l1_checkpoint(tmp_path_factory):
    """A timm-layout Uni3D twin at full width, depth 1."""
    torch.manual_seed(3)
    twin = TorchUni3D(1024, 1024, 512, 1, 16).eval()
    path = tmp_path_factory.mktemp("report") / "uni3d_L1.pt"
    torch.save({"module." + k: v for k, v in twin.state_dict().items()},
               path)
    return path


@pytest.mark.parametrize("layout", ["clean", "diffs"])
def test_report_cli_prints_what_the_jax_cli_prints(layout, tmp_path,
                                                   uni3d_l1_checkpoint,
                                                   capsys):
    """The report CLI prints the JAX CLI's report line for line, with its
    last line and its exit code: CLEAN (0) for the timm-layout Uni3D
    twin at full width and depth 1, DIFFS FOUND (1) once a bias is dropped
    and a stray key added.  `python -m uni_adapter_torch.models.loader`
    prints the same in a subprocess (the clean case)."""
    path = uni3d_l1_checkpoint
    if layout == "diffs":
        sd = torch.load(path, weights_only=False)
        sd.pop("module.point_encoder.visual.blocks.0.attn.proj.bias")
        sd["module.stray.weight"] = torch.zeros(3)
        path = tmp_path / "diffs.pt"
        torch.save(sd, path)
    args = [str(path), "--vlm3d", "uni3d", "--eva-depth", "1", "--device",
            "cpu"]
    want_rc = jloader.report_main(args)
    want = capsys.readouterr().out
    got_rc = loader.report_main(args)
    got = capsys.readouterr().out
    assert got_rc == want_rc == (0 if layout == "clean" else 1)
    assert got == want
    assert got.splitlines()[-1] == (
        "STRICT OVERLAY: CLEAN" if layout == "clean"
        else "STRICT OVERLAY: DIFFS FOUND")
    if layout == "diffs":
        assert "  params/point_encoder/blocks_0/attn/proj/bias" in got
        assert "  stray/scale" in got
        return
    proc = subprocess.run(
        [sys.executable, "-m", "uni_adapter_torch.models.loader", *args],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == want_rc, proc.stderr
    assert proc.stdout == want


def test_report_cli_without_gpu_and_without_device_cpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="--device cpu"):
        loader.report_main([str(tmp_path / "x.pt")])


def test_extract_attention_checkpoint_gives_the_jax_maps(tmp_path,
                                                         monkeypatch):
    """`--checkpoint` on Uni3D-L (width 1024, depth 1, the timm layout):
    the JAX CLI's maps from the same file, in bf16 as both CLIs run
    (within 1e-2, as tests/test_torch_attention_maps.py holds bf16 maps;
    every row summing to 1), and the same statistics keys.  Both CLIs'
    figures are left out (tests/test_torch_attention_maps.py draws the
    port's)."""
    from uni_adapter_tpu.analysis import attention as jA
    from uni_adapter_tpu.cli import extract_attention as jextract

    for name in dir(jA):
        if name.startswith("visualize_"):
            monkeypatch.setattr(jA, name, lambda *a, **k: None)

    src = create_uni3d(ModelConfig(eva_depth=1, compute_dtype="float32"),
                       "cpu", seed=9)
    path = tmp_path / "uni3d.pt"
    reference_layouts.save(reference_layouts.uni3d(src), path)
    args = ["--vlm3d", "uni3d", "--depth", "1", "--checkpoint", str(path),
            "--device", "cpu"]
    jextract.main([*args, "--out", str(tmp_path / "jax")])
    args_p = extract_attention.parse_args([*args, "--out",
                                           str(tmp_path / "port")])
    extract_attention.extract(args_p)
    want = np.load(tmp_path / "jax" / "attention_maps.npz")
    got = np.load(tmp_path / "port" / "attention_maps.npz")
    assert got.files == want.files == ["layer_0"]
    assert got["layer_0"].shape == (1, 16, 513, 513)
    np.testing.assert_allclose(got["layer_0"], want["layer_0"], rtol=0,
                               atol=1e-2)
    np.testing.assert_allclose(got["layer_0"].sum(-1), 1.0, atol=1e-5)
    stats = [json.loads((tmp_path / d / "attention_stats.json").read_text())
             for d in ("jax", "port")]
    assert stats[0].keys() == stats[1].keys()
