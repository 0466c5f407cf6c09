"""The port's text side against the JAX package on the CPU: the tokenizer
(stdlib `re`, against the JAX one on the third-party `regex`), the CLIP
text tower, the template-ensemble anchors and their precedence, and the
two CLIs that reach the tower: `build_anchors` and the evaluation CLI
without a bank, each on a reference-layout CLIP checkpoint.

The tower's weights are the JAX tower's (`weights.from_jax_params`) or a
checkpoint both packages load; inputs come from numpy seeds.
"""
import json
import logging
import unicodedata

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from uni_adapter_tpu import anchors as janchors
from uni_adapter_tpu import config as jcfg
from uni_adapter_tpu.models import clip_text as jclip
from uni_adapter_tpu.models.loader import _flat_param_paths
from uni_adapter_tpu.utils import tokenizer as jtok
from uni_adapter_torch import anchors as panchors
from uni_adapter_torch import config as pcfg
from uni_adapter_torch.config import ASSETS_DIR
from uni_adapter_torch.models import clip_text as pclip
from uni_adapter_torch.models.loader import param_paths
from uni_adapter_torch.models.pointbert import create_ulip
from uni_adapter_torch.utils import tokenizer as ptok
from uni_adapter_torch.weights import from_jax_params
from scripts import reference_layouts
from torch_threads import one_torch_thread  # noqa: F401


#: Both packages' tokenizers, built once.
_TOKS = (ptok.SimpleTokenizer(), jtok.SimpleTokenizer())


@pytest.fixture(scope="module")
def toks():
    return _TOKS


def _split(tok, module, text):
    """What the tokenizer's BPE sees: the cleaned, lower-cased text's
    pre-tokens (the BPE itself is the same code in both packages)."""
    return tok.pat.findall(
        module.whitespace_clean(module.basic_clean(text)).lower())


# --------------------------------------------------------------------------
# the tokenizer
# --------------------------------------------------------------------------

def _prompts(key):
    labels = json.load(open(f"{ASSETS_DIR}/labels.json"))[key]
    templates = json.load(open(f"{ASSETS_DIR}/templates.json"))
    return [t.format(n.replace("_", " ")) for n in labels
            for tk in templates for t in templates[tk]]


@pytest.mark.parametrize("key", ["modelnet40_openshape", "scanobjnn_openshape",
                                 "shapenet_openshape",
                                 "objaverse_lvis_openshape"])
def test_tokenizer_matches_jax_on_every_label_and_template(toks, key):
    """Every label of the key under every template of templates.json: the
    same pre-tokens as the JAX tokenizer, prompt by prompt (the prompts
    joined by " | ": no pre-token spans whitespace, and no prompt holds a
    "|", so the joined lists split back into the prompts' own); the same
    (B, 77) ids for all of them, except LVIS's 148k prompts, whose ids are
    compared under the first template of each templates.json key."""
    pt, jt = toks
    prompts = _prompts(key)
    assert not any("|" in p for p in prompts)
    joined = " | ".join(prompts)
    got = _split(pt, ptok, joined)
    assert got == _split(jt, jtok, joined)
    assert got.count("|") == len(prompts) - 1
    if key == "objaverse_lvis_openshape":
        prompts = prompts[::64]
    np.testing.assert_array_equal(pt(prompts), jt(prompts))


def test_tokenizer_golden_ids_and_truncation(toks):
    """tests/test_data.py's golden ids; a prompt past 77 tokens is cut
    plainly, EOT dropped, in both packages."""
    pt, jt = toks
    out = pt("a photo of a cat")
    assert out.dtype == np.int32 and out.shape == (1, 77)
    np.testing.assert_array_equal(out[0, :7], [49406, 320, 1125, 539, 320,
                                               2368, 49407])
    assert not out[0, 7:].any()
    long = " ".join(["chair"] * 200)
    got = pt([long, "a photo of a cat"])
    np.testing.assert_array_equal(got, jt([long, "a photo of a cat"]))
    assert got[0, -1] != 49407 and (got[0] == 49407).sum() == 0
    assert ptok.tokenize("a cat").shape == (1, 77)


def test_tokenizer_splits_every_code_point_as_jax(toks):
    """Every code point assigned in this Python's Unicode tables, in a
    context of letters, digits, whitespace and a contraction: the same
    pre-tokens as `regex` gives (U+0345, which case-folds to a letter,
    dropped; U+001C-U+001F not whitespace; Nl/No numerics one at a
    time)."""
    pt, jt = toks
    chars = [chr(c) for c in range(0x110000)
             if not 0xD800 <= c <= 0xDFFF
             and unicodedata.category(chr(c)) != "Cn"]
    for s in range(0, len(chars), 2048):
        text = " ".join(f"a{c}b {c}{c}1{c}'s" for c in chars[s:s + 2048])
        assert _split(pt, ptok, text) == _split(jt, jtok, text)
    assert _split(pt, ptok, "x²½Ⅻ7ͅy") == ["x", "²", "½", "ⅻ", "7", "y"]


_PIECES = st.one_of(
    st.characters(categories=("L", "M", "N", "P", "S", "Z", "Cc")),
    st.sampled_from(["'s", "'t", "'re", "'ve", "'m", "'ll", "'d", "'S",
                     "'ſ", " ", "\t", "\n", "\x1c", "<|endoftext|>",
                     "&amp;", "²", "½", "Ⅻ", "ͅ"]))


@settings(max_examples=200, deadline=None, derandomize=True)
@given(st.lists(_PIECES, max_size=40).map("".join))
def test_tokenizer_matches_jax_on_drawn_text(text):
    """Letters, marks, Nd/Nl/No numerics, punctuation, symbols, whitespace
    and control characters, contractions and specials: the same ids (the
    draws take the categories of this Python's Unicode tables)."""
    pt, jt = _TOKS
    assert pt.encode(text) == jt.encode(text)
    np.testing.assert_array_equal(pt(text), jt(text))


# --------------------------------------------------------------------------
# the tower
# --------------------------------------------------------------------------

def test_text_presets_and_shapes_match_the_flax_tree():
    """TEXT_PRESETS is the JAX package's; each preset's parameters, by flax
    path, have the flax tree's shapes (jax.eval_shape, no init)."""
    assert pclip.TEXT_PRESETS == jclip.TEXT_PRESETS
    for name in pclip.TEXT_PRESETS:
        tree = jax.eval_shape(jclip.create_text_encoder(name).init,
                              jax.random.PRNGKey(0),
                              jnp.zeros((1, 77), jnp.int32))
        with torch.device("meta"):
            tower = pclip.TextEncoder(**pclip.TEXT_PRESETS[name])
        assert [(p, h.shape) for p, _, _, h in param_paths(tower)] == [
            (p, tuple(leaf.shape)) for p, leaf in _flat_param_paths(tree)]


#: The tiny tower: vocab 1000, width 64, 2 layers of 4 heads, embed 32.
TINY = dict(vocab_size=1000, width=64, layers=2, heads=4, embed_dim=32)


def _tiny_towers(dtype, **dims):
    dims = {**TINY, **dims}
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jt = jclip.TextEncoder(dtype=jdt, **dims)
    params = jax.jit(jt.init)(jax.random.PRNGKey(3),
                              jnp.zeros((1, 77), jnp.int32))
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    pt = pclip.create_text_encoder("ulip", "cpu", dtype, state_dict=sd,
                                   **dims)
    return jt, params, pt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiny_tower_matches_jax(dtype):
    """The tiny tower on the JAX tower's weights: fp32 within rtol 1e-5 /
    atol 1e-6; bf16 within atol 1e-2 (outputs up to ~0.4: both sides
    round to bf16 at the same points, but a sum in another order can flip
    a rounding; max |Δ| 3.8e-3 here).  Rows: EOT then padding, EOT at the
    last slot, two equal maxima (the first pools), and a prompt truncated
    past 77 tokens with its EOT gone."""
    jt, params, pt = _tiny_towers(dtype)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 999, (4, 77)).astype(np.int32)
    ids[0, 9], ids[0, 10:] = 999, 0
    ids[1, -1] = 999
    ids[2, 5] = ids[2, 40] = 999
    want = np.asarray(jax.jit(jt.apply)(params, jnp.asarray(ids)))
    with torch.no_grad():
        got = pt(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (4, 32)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2)


# --------------------------------------------------------------------------
# anchors
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def full_vocab_towers():
    """The tiny tower at the tokenizer's vocabulary, fp32, both packages,
    with a jitted JAX encode."""
    jt, params, pt = _tiny_towers(torch.float32, vocab_size=49408)
    apply = jax.jit(jt.apply)
    return (lambda t: apply(params, t)), pt


def test_clip_classifier_matches_jax(full_vocab_towers):
    """ModelNet40's 40 classes × 64 templates through the tiny tower: the
    JAX package's (40, 32) rows within atol 1e-6, unit norm."""
    jencode, pt = full_vocab_towers
    names = pcfg.load_labels(pcfg.Config())
    templates = pcfg.load_templates(pcfg.Config())
    assert names == jcfg.load_labels(jcfg.Config())
    assert templates == jcfg.load_templates(jcfg.Config())
    want = np.asarray(janchors.clip_classifier(names, templates, jencode))
    got = panchors.clip_classifier(names, templates, pt, batch_size=256)
    assert got.dtype == torch.float32 and got.shape == (40, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.norm(dim=1).numpy(), 1.0, atol=1e-6)


@pytest.fixture
def small_text_files(tmp_path):
    """labels.json / templates.json with 5 classes and 3 templates."""
    labels = tmp_path / "labels.json"
    labels.write_text(json.dumps({"modelnet40_openshape": [
        "airplane", "night_stand", "tv_stand", "cup", "xbox"]}))
    templates = tmp_path / "templates.json"
    templates.write_text(json.dumps({"t3": [
        "a photo of a {}.", "a point cloud of a {}.", "{} in 3D."]}))
    return str(labels), str(templates)


@pytest.mark.parametrize("case", ["bank", "missing_bank", "none",
                                  "missing_bank_no_tower"])
def test_get_text_anchors_precedence_matches_jax(case, full_vocab_towers,
                                                 small_text_files, tmp_path,
                                                 caplog):
    """A bank configured and present is used; configured but missing, a
    warning and the tower; neither, ValueError; a missing bank without a
    tower, FileNotFoundError.  Rows equal the JAX package's (atol 1e-6)."""
    jencode, pt = full_vocab_towers
    pre = {"bank": "large", "missing_bank": str(tmp_path / "gone.npy"),
           "none": None, "missing_bank_no_tower": str(tmp_path / "gone.npy")}
    data = dict(precomputed_text_features=pre[case],
                labels_path=small_text_files[0],
                templates_path=small_text_files[1], template_key="t3")
    pc = pcfg.Config(data=pcfg.DataConfig(**data)).resolve()
    jc = jcfg.Config(data=jcfg.DataConfig(**data)).resolve()
    if case == "none":
        for fn, cfg in ((janchors.get_text_anchors, jc),
                        (panchors.get_text_anchors, pc)):
            with pytest.raises(ValueError, match="no text"):
                fn(cfg)
    if case == "missing_bank_no_tower":
        for fn, cfg in ((janchors.get_text_anchors, jc),
                        (panchors.get_text_anchors, pc)):
            with pytest.raises(FileNotFoundError):
                fn(cfg)
    if case in ("none", "missing_bank_no_tower"):
        return
    want = np.asarray(janchors.get_text_anchors(jc, encode_text_fn=jencode))
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        got = panchors.get_text_anchors(pc, encode_text_fn=pt)
    assert ("not found; computing anchors on the fly" in caplog.text) == (
        case == "missing_bank")
    assert got.shape == want.shape == ((40, 1024) if case == "bank"
                                       else (5, 32))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clip_checkpoint(tmp_path_factory):
    """The full `ulip` text preset (width 512, 12 layers, 49408 tokens),
    random from a seed, written in open_clip's layout."""
    tower = pclip.create_text_encoder("ulip", "cpu", torch.float32, seed=7)
    path = tmp_path_factory.mktemp("clip") / "clip_ulip.pt"
    reference_layouts.save(reference_layouts.clip_text(tower), path)
    return str(path)


def test_build_anchors_writes_the_jax_bank(clip_checkpoint, small_text_files,
                                           tmp_path, capsys):
    """Both CLIs on the same checkpoint, labels and templates (fp32 tower):
    the same row-normalised (5, 512) bank within atol 1e-6, and
    `--compare-to` against the JAX bank."""
    from uni_adapter_tpu.cli import build_anchors as jbuild
    from uni_adapter_torch.cli import build_anchors as pbuild

    args = ["--text-preset", "ulip", "--clip-checkpoint", clip_checkpoint,
            "--labels-key", "modelnet40_openshape", "--labels-path",
            small_text_files[0], "--templates-path", small_text_files[1],
            "--template-key", "t3", "--device", "cpu"]
    jbuild.main([*args, "--out", str(tmp_path / "jax.npy")])
    capsys.readouterr()
    got = pbuild.main([*args, "--out", str(tmp_path / "port"),
                       "--compare-to", str(tmp_path / "jax.npy")])
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    want = np.load(tmp_path / "jax.npy")
    saved = np.load(tmp_path / "port.npy")
    assert saved.dtype == np.float32 and saved.shape == (5, 512)
    np.testing.assert_array_equal(saved, got)
    np.testing.assert_allclose(saved, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(saved, axis=1), 1.0, atol=1e-6)
    assert summary["K"] == 5 and summary["D"] == 512
    assert summary["max_abs_diff"] <= 1e-6


def test_tta_cli_without_a_bank_writes_the_jax_results(clip_checkpoint,
                                                       small_text_files,
                                                       tmp_path, caplog):
    """`--checkpoint-path` (ULIP-2 at small point widths, 512-d features,
    Point-BERT layout) and `--clip-checkpoint-path` (the `ulip` tower,
    bf16 in both CLIs) with no bank: the same results.json and
    results_zs.json as the JAX CLI on the same two files, the anchors from
    the tower, and no random-weights warning."""
    from uni_adapter_tpu.cli import tta as jtta
    from uni_adapter_torch.cli import tta

    point_args = ["--vlm3d", "ulip", "--ulip-depth", "2", "--ulip-trans-dim",
                  "64", "--ulip-heads", "1", "--num-group", "16",
                  "--ulip-group-size", "8", "--ulip-encoder-dim", "32",
                  "--npoints", "128", "--compute-dtype", "float32"]
    point = create_ulip(pcfg.parse_args(point_args).model, "cpu", seed=11)
    point_path = tmp_path / "ulip.pt"
    reference_layouts.save(reference_layouts.ulip(point), point_path)
    rng = np.random.default_rng(0)
    root = tmp_path / "data"
    root.mkdir()
    np.save(root / "data_uniform_5.npy",
            rng.standard_normal((8, 128, 3)).astype(np.float32))
    np.save(root / "label.npy", rng.integers(0, 5, (8,)).astype(np.int64))
    argv = ["--device", "cpu", "--root", str(root), "--corruption",
            "uniform", *point_args, "--checkpoint-path", str(point_path),
            "--clip-checkpoint-path", clip_checkpoint, "--labels-path",
            small_text_files[0], "--templates-path", small_text_files[1],
            "--template-key", "t3", "--name", "run"]
    jtta.main([*argv, "--output-dir", str(tmp_path / "jax")])
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        summary = tta.main([*argv, "--output-dir", str(tmp_path / "port")])
    assert "random weights" not in caplog.text
    assert summary["finite"]["uniform"] and summary["n"]["uniform"] == 8
    for name in ("results.json", "results_zs.json"):
        assert json.loads((tmp_path / "port" / "run" / name).read_text()) \
            == json.loads((tmp_path / "jax" / "run" / name).read_text())
