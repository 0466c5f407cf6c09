"""Uni3D in the port against the JAX package on the CPU: the weight
mapping (`uni_adapter_torch.weights.from_jax_params`) and the encoder's
features, with the JAX side on its three kernel branches in interpret
mode and the port on the kernels' plain versions."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uni_adapter_tpu.ops.attention_pallas as attention_pallas
import uni_adapter_tpu.ops.fps_pallas as fps_pallas
import uni_adapter_tpu.ops.knn_pallas as knn_pallas
from uni_adapter_tpu.config import ModelConfig as JaxModelConfig
from uni_adapter_tpu.models.uni3d import create_uni3d as jax_create_uni3d
from uni_adapter_torch.config import ModelConfig
from uni_adapter_torch.models.uni3d import Uni3D, create_uni3d
from uni_adapter_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401


SMALL = dict(pc_feat_dim=64, embed_dim=32, num_group=16, group_size=8,
             pc_encoder_dim=32, eva_depth=2, eva_heads=4,
             compute_dtype="float32")


@pytest.fixture
def pallas_interpret(monkeypatch):
    for mod, name in ((fps_pallas, "fps_pallas_batched"),
                      (knn_pallas, "knn_pallas"),
                      (attention_pallas, "eva_attn_block_fused")):
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), interpret=True))


def jax_uni3d(**kw):
    """The JAX Uni3D on the three kernel branches the port mirrors."""
    return jax_create_uni3d(JaxModelConfig(
        use_pallas_fps=True, use_pallas_knn=True, use_pallas_attn_block=True,
        **kw))


def perturbed_params(model, example, seed=0):
    """flax init, then every leaf moved off its init value, so the mapping
    of LayerNorm/BatchNorm/bias/cls leaves is exercised too."""
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), example)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
        .astype(np.float32), params)


def test_weight_mapping_covers_uni3d_large_names_and_shapes():
    """At the real width (1024, 16 heads, SwiGLU hidden 2730; depth cut to
    1), every flax leaf lands on a port parameter of the right shape."""
    cfg = dict(eva_depth=1)
    model = jax_uni3d(**cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 1024, 6), jnp.float32))
    tree = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    mapped = {k: tuple(v.shape) for k, v in from_jax_params(tree).items()}
    with torch.device("meta"):
        port = Uni3D(depth=1)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert mapped == want
    assert want["point_encoder.blocks.0.mlp.fc1_g.weight"] == (2730, 1024)


def test_uni3d_features_match_jax(pallas_interpret):
    """fp32, depth 2, width 64: features within 1e-4 (the same arithmetic
    summed in other orders; FPS/kNN indices are exact)."""
    model = jax_uni3d(**SMALL)
    rng = np.random.default_rng(1)
    pc = np.concatenate([rng.standard_normal((2, 128, 3)),
                         rng.uniform(size=(2, 128, 3))], -1).astype(np.float32)
    params = perturbed_params(model, jnp.asarray(pc))
    want = np.asarray(model.apply(params, jnp.asarray(pc)))

    port = create_uni3d(ModelConfig(**SMALL), "cpu",
                        state_dict=from_jax_params(params))
    with torch.no_grad():
        got = port(torch.from_numpy(pc))
    assert got.dtype == torch.float32 and got.shape == (2, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_random_init_is_seeded_and_frozen():
    a = create_uni3d(ModelConfig(**SMALL), "cpu", seed=3)
    b = create_uni3d(ModelConfig(**SMALL), "cpu", seed=3)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not any(p.requires_grad for p in a.parameters())
    assert not a.training
