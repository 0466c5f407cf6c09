"""The port's int8 trunk (`models/common.py::QuantDense`, Uni3D with
`quantize_int8`) against the JAX package's `QuantDense` and quantised
Uni3D on the CPU, on the same parameters.

The int32 products are compared exactly: the port's plain version is
integer arithmetic, and JAX's product is computed here by the JAX
layer's own lines (held equal to the layer's output first).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uni_adapter_tpu import config as jcfg
from uni_adapter_tpu.models.common import QuantDense as JaxQuantDense
from uni_adapter_tpu.models.uni3d import Uni3D as JaxUni3D
from uni_adapter_torch import config as pcfg
from uni_adapter_torch.cli import tta
from uni_adapter_torch.models import common
from uni_adapter_torch.models.common import Dense, QuantDense
from uni_adapter_torch.models.uni3d import Uni3D, create_uni3d
from uni_adapter_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

UNI3D = dict(trans_dim=32, embed_dim=24, num_group=8, group_size=8,
             encoder_dim=16, depth=2, num_heads=4)


def jax_int8_product(x, kernel):
    """The JAX layer's quantisation and int32 product, its own lines."""
    xf = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
    sx = jnp.max(jnp.abs(xf), axis=1, keepdims=True) / 127.0 + 1e-12
    sw = jnp.max(jnp.abs(kernel), axis=0, keepdims=True) / 127.0 + 1e-12
    xq = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
    wq = jnp.clip(jnp.round(kernel / sw), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(xq, wq, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    return np.asarray(acc), np.asarray(acc.astype(jnp.float32) * sx * sw)


def port_layer(params, bias=True) -> QuantDense:
    kernel = np.asarray(params["params"]["kernel"])
    layer = QuantDense(*kernel.shape, bias=bias)
    layer.weight.data = torch.from_numpy(kernel.T.copy())
    if bias:
        layer.bias.data = torch.from_numpy(
            np.asarray(params["params"]["bias"]).copy())
    return layer


@pytest.mark.parametrize("rows,width,features", [
    (64, 96, 48), (7, 2730, 10), (7, 10, 2730), (1, 24, 8)])
def test_quantdense_matches_jax(rows, width, features):
    """The int32 products equal, the outputs within 1e-6 relative, at
    SwiGLU's odd width 2730 in both directions and at one row."""
    rng = np.random.default_rng(rows + width)
    x = (3.0 * rng.standard_normal((rows, width))).astype(np.float32)
    layer = JaxQuantDense(features, dtype=jnp.float32)
    params = layer.init(jax.random.PRNGKey(0), x)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        params)                                   # a nonzero bias
    want = np.asarray(layer.apply(params, x))
    acc, scaled = jax_int8_product(jnp.asarray(x),
                                   params["params"]["kernel"])
    np.testing.assert_array_equal(
        scaled + np.asarray(params["params"]["bias"]), want)
    port = port_layer(params)
    xq, _ = common.quantize_rows(torch.from_numpy(x))
    wq, _ = common.quantize_rows(port.weight.data)
    got_acc = common.int8_matmul(xq, wq)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), acc)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("m,k,n", [(1, 2730, 1024), (40, 1024, 2730),
                                   (17, 8, 8), (5, 3, 5)])
def test_int_mm_padding_meets_the_card_limits(monkeypatch, m, k, n):
    """The card's route pads to `torch._int_mm`'s limits (M > 16, K and N
    multiples of 8) and drops the padding: equal to the plain int32
    product (`torch._int_mm` itself run here on the CPU, its limits
    asserted)."""
    mm = torch._int_mm

    def checked(a, b):
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0
        assert b.shape[1] % 8 == 0 and a.shape[1] == b.shape[0]
        return mm(a, b)

    monkeypatch.setattr(torch, "_int_mm", checked)
    g = torch.Generator().manual_seed(m)
    xq = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    got = common.int_mm_padded(xq, wq)
    assert got.shape == (m, n)
    assert torch.equal(got, common.int8_matmul(xq, wq))


def test_parameter_names_are_dense_ones():
    """QuantDense keeps Dense's parameters, so `from_jax_params` and the
    checkpoint loader map the int8 trunk unchanged; only its
    compute-dtype storage differs (fp32 weights)."""
    assert ({k: v.shape for k, v in QuantDense(8, 6).state_dict().items()}
            == {k: v.shape for k, v in Dense(8, 6).state_dict().items()})
    kw = dict(trans_dim=32, embed_dim=24, num_group=8, group_size=8,
              encoder_dim=16, depth=1, num_heads=4)
    assert (Uni3D(**kw, quantize=True).state_dict().keys()
            == Uni3D(**kw).state_dict().keys())
    cfg = pcfg.ModelConfig(pc_feat_dim=32, embed_dim=24, num_group=8,
                           group_size=8, pc_encoder_dim=16, eva_depth=1,
                           eva_heads=4, quantize_int8=True)
    model = create_uni3d(cfg, "cpu")
    blk = model.point_encoder.blocks[0]
    assert isinstance(blk.mlp.fc2, QuantDense)
    assert blk.mlp.fc2.weight.dtype == torch.float32
    assert blk.attn.q_norm.weight.dtype == torch.float32
    assert model.point_encoder.encoder2trans.weight.dtype == torch.bfloat16


def test_quantised_uni3d_matches_jax():
    """A small quantised Uni3D (depth 2, fp32) against JAX's on the same
    parameters within 1e-5; the attention goes through `attend` (on the
    card the (B, H, N, hd) kernel), never the block kernel."""
    rng = np.random.default_rng(0)
    pc = rng.standard_normal((2, 64, 6)).astype(np.float32)
    jmodel = JaxUni3D(quantize=True, dtype=jnp.float32, **UNI3D)
    params = jmodel.init(jax.random.PRNGKey(0), pc)
    want = np.asarray(jax.jit(jmodel.apply)(params, pc))
    port = Uni3D(**UNI3D, dtype=torch.float32, quantize=True)
    port.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(pc)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    plain = np.asarray(jax.jit(JaxUni3D(dtype=jnp.float32, **UNI3D).apply)(
        params, pc))
    cos = (got * plain).sum(-1) / (np.linalg.norm(got, axis=-1)
                                   * np.linalg.norm(plain, axis=-1))
    assert np.all(cos > 0.99), cos
    assert not np.allclose(got, plain, atol=1e-5)


def test_flag_parses_as_in_jax_and_the_cli_runs(tmp_path):
    """`--quantize-int8 true` parses as the JAX parser parses it (default
    False), and the evaluation CLI runs the int8 trunk on the CPU."""
    for argv in ([], ["--quantize-int8", "true"],
                 ["--quantize-int8", "false"]):
        assert (pcfg.parse_args(argv).model.quantize_int8
                == jcfg.parse_args(argv).model.quantize_int8)
    rng = np.random.default_rng(0)
    np.save(tmp_path / "data_uniform_5.npy",
            rng.standard_normal((4, 64, 3)).astype(np.float32))
    np.save(tmp_path / "label.npy", rng.integers(0, 40, (4,)))
    summary = tta.main([
        "--device", "cpu", "--root", str(tmp_path), "--corruption",
        "uniform", "--output-dir", str(tmp_path / "out"), "--name", "q",
        "--quantize-int8", "true", "--npoints", "64", "--eva-depth", "1",
        "--pc-feat-dim", "64", "--num-group", "8", "--group-size", "8",
        "--pc-encoder-dim", "32", "--eva-heads", "4",
        "--compute-dtype", "float32", "--precomputed-text-features",
        "large"])
    res = json.loads((tmp_path / "out" / "q" / "results.json").read_text())
    assert set(res) == {"uniform"}
    assert summary["finite"]["uniform"] and summary["steps"]["uniform"] == [
        0, 4]
