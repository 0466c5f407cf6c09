"""MODE-DOTA adaptation in the port against the JAX package on the CPU:
the mixture, the fusion, residual learning, and the engine step for step.

The noise of the fused clean + noise-augmented forward is drawn with
`jax.random` exactly as the JAX step draws it and handed to the port's
step, so both sides adapt on the same clouds.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import uni_adapter_tpu.ops.attention_pallas as attention_pallas
import uni_adapter_tpu.ops.fps_pallas as fps_pallas
import uni_adapter_tpu.ops.knn_pallas as knn_pallas
from uni_adapter_tpu import config as jcfg_mod
from uni_adapter_tpu import engine as jengine
from uni_adapter_tpu.adapt import fusion as jfusion
from uni_adapter_tpu.adapt import mode_dota as jmd
from uni_adapter_tpu.adapt import residual as jres
from uni_adapter_tpu.models.uni3d import create_uni3d as jax_create_uni3d
from uni_adapter_tpu.utils.metrics import topk_correct as jax_topk_correct
from uni_adapter_torch import config as pcfg_mod
from uni_adapter_torch import engine as pengine
from uni_adapter_torch.adapt import fusion, mode_dota, residual
from uni_adapter_torch.models.uni3d import create_uni3d
from uni_adapter_torch.utils.metrics import topk_correct
from uni_adapter_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401


EPS = 1e-4
SMALL = dict(pc_feat_dim=64, embed_dim=32, num_group=16, group_size=8,
             pc_encoder_dim=32, eva_depth=2, eva_heads=4,
             compute_dtype="float32")


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def to_port_state(s) -> mode_dota.ModeDotaState:
    return mode_dota.ModeDotaState(_t(s.mu), _t(s.var), _t(s.pi), _t(s.c),
                                   _t(s.class_counts), int(s.t))


def assert_state_close(port, jax_state, tol):
    for name in ("mu", "var", "pi", "c", "class_counts"):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(jax_state, name)),
                                   rtol=tol, atol=tol, err_msg=name)
    assert port.t == int(jax_state.t)


@pytest.fixture
def fitted():
    """A MODE-DOTA state after two EM fits on both sides, plus inputs."""
    rng = np.random.default_rng(0)
    K, D, B = 6, 16, 3
    text = _unit_rows(rng, K, D)
    xs = [_unit_rows(rng, B, D) for _ in range(2)]
    gamma = np.asarray(jax.nn.softmax(
        jnp.asarray(rng.standard_normal((B, K)) * 3.0), axis=1))
    js = jmd.init(EPS, 1e-4, D, K, jnp.asarray(text.T), num_modes=4)
    ps = mode_dota.init(EPS, 1e-4, D, K, _t(text.T), num_modes=4)
    for x in xs:
        js = jmd.fit(js, jnp.asarray(x), jnp.asarray(gamma), EPS)
        ps = mode_dota.fit(ps, _t(x), _t(gamma), EPS)
    return text, xs, gamma, js, ps


def test_mode_dota_init_fit_predict_match(fitted):
    """fp32 within 1e-5 (relative): the same EM in another summation
    order."""
    text, xs, _, js, ps = fitted
    K, D = text.shape
    assert_state_close(mode_dota.init(EPS, 1e-4, D, K, _t(text.T)),
                       jmd.init(EPS, 1e-4, D, K, jnp.asarray(text.T)), 1e-6)
    assert_state_close(ps, js, 1e-5)
    np.testing.assert_allclose(
        mode_dota.predict(ps, _t(xs[0]), EPS).numpy(),
        np.asarray(jmd.predict(js, jnp.asarray(xs[0]), EPS)), rtol=1e-5)


@pytest.mark.parametrize("fix", [False, True])
def test_fuse_mode_dota_matches(fix):
    rng = np.random.default_rng(1)
    clip = (rng.standard_normal((3, 7)) * 5).astype(np.float32)
    dota = (rng.standard_normal((3, 7)) * 50).astype(np.float32)
    w = fusion.dota_fusion_weight(0.02, 0.1, torch.tensor(2.5), 1.0)
    jw = jfusion.dota_fusion_weight(0.02, 0.1, jnp.float32(2.5), 1.0)
    np.testing.assert_allclose(float(w), float(jw), rtol=1e-7)
    np.testing.assert_allclose(
        fusion.fuse_mode_dota(_t(clip), _t(dota), w, fix).numpy(),
        np.asarray(jfusion.fuse_mode_dota(jnp.asarray(clip), jnp.asarray(dota),
                                          jw, fix)), rtol=1e-5, atol=1e-5)


def test_topk_correct_matches_with_ties():
    logits = np.array([[1., 3., 3., 0., 2., 3.],
                       [0., 0., 0., 0., 0., 0.]], np.float32)
    for target in ([2, 4], [5, 0], [1, 5]):
        np.testing.assert_array_equal(
            topk_correct(_t(logits), torch.tensor(target)).numpy(),
            np.asarray(jax_topk_correct(jnp.asarray(logits),
                                        jnp.asarray(target))))


def test_alignment_loss_gradient_and_adam_step_match(fitted):
    """Loss value, its gradient, and one optax-adam step within rtol 1e-4
    (the loss runs exp(exp(·)), which amplifies last-bit differences)."""
    text, _, _, js, ps = fitted
    emb = _unit_rows(np.random.default_rng(2), *text.shape)
    jl, jg = jax.value_and_grad(jres.alignment_loss)(jnp.asarray(emb), js, EPS)
    e = _t(emb).requires_grad_(True)
    loss = residual.alignment_loss(e, ps, EPS)
    (g,) = torch.autograd.grad(loss, e)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jg).max()))

    opt = optax.adam(1e-3)
    jrs = jres.optimize_residuals(jres.init(jnp.asarray(text), opt),
                                  jnp.asarray(text), js, opt, EPS,
                                  num_steps=1)
    prs = residual.optimize_residuals(residual.init(_t(text)), _t(text), ps,
                                      1e-3, EPS, num_steps=1)
    np.testing.assert_allclose(prs.residuals.numpy(),
                               np.asarray(jrs.residuals), rtol=1e-4,
                               atol=1e-8)
    assert prs.count == 1
    np.testing.assert_allclose(
        residual.adapted_text_weights(prs, _t(text)).numpy(),
        np.asarray(jres.adapted_text_weights(jrs, jnp.asarray(text))),
        rtol=1e-5, atol=1e-6)


@pytest.fixture
def pallas_interpret(monkeypatch):
    for mod, name in ((fps_pallas, "fps_pallas_batched"),
                      (knn_pallas, "knn_pallas"),
                      (attention_pallas, "eva_attn_block_fused")):
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), interpret=True))


def _both_engines(res_learning: bool):
    """The same small Uni3D and MODE-DOTA config in both packages."""
    jcfg = jcfg_mod.Config(
        model=jcfg_mod.ModelConfig(use_pallas_fps=True, use_pallas_knn=True,
                                   use_pallas_attn_block=True, **SMALL),
        dota=jcfg_mod.DotaConfig(res_learning=res_learning))
    pcfg = pcfg_mod.Config(model=pcfg_mod.ModelConfig(**SMALL),
                           dota=pcfg_mod.DotaConfig(res_learning=res_learning))
    jmodel = jax_create_uni3d(jcfg.model)
    rng = np.random.default_rng(3)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 128, 6), jnp.float32))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
        .astype(np.float32), params)
    pmodel = create_uni3d(pcfg.model, "cpu", state_dict=from_jax_params(params))
    text = _unit_rows(rng, 10, SMALL["embed_dim"])
    return jcfg, pcfg, jmodel, params, pmodel, text


def _run_both(res_learning, steps):
    jcfg, pcfg, jmodel, params, pmodel, text = _both_engines(res_learning)
    jstep = jax.jit(jengine.make_step_fn(jcfg, jmodel))
    pstep = pengine.make_step_fn(pcfg, pmodel)
    js = jengine.init_state(jcfg, jnp.asarray(text), jax.random.PRNGKey(42))
    ps = pengine.init_state(pcfg, _t(text))
    rng = np.random.default_rng(4)
    for _ in range(steps):
        pc = rng.standard_normal((1, 128, 3)).astype(np.float32)
        rgb = np.ones_like(pc)
        target = rng.integers(0, 10, (1,)).astype(np.int32)
        # the JAX step's own draw: split the carried key, normal(noise key)
        noise = jax.random.normal(jax.random.split(js.rng)[1], pc.shape,
                                  jnp.float32)
        js, jout = jstep(params, jnp.asarray(text), js,
                         (jnp.asarray(pc), jnp.asarray(rgb),
                          jnp.asarray(target)))
        ps, pout = pstep(_t(text), ps, (_t(pc), _t(rgb), _t(target)),
                         noise=_t(noise))
        yield js, jout, ps, pout


def test_engine_matches_step_for_step_without_residuals(pallas_interpret):
    """5 steps, res_learning off: final and CLIP logits within atol 1e-3
    (logits are 100·cosine, so 1e-5 relative), identical correct counts
    and summaries."""
    jouts, pouts = [], []
    for js, jout, ps, pout in _run_both(False, steps=5):
        jouts.append(jout)
        pouts.append(pout)
        np.testing.assert_allclose(pout.final_logits.numpy(),
                                   np.asarray(jout.final_logits), atol=1e-3)
        np.testing.assert_allclose(pout.clip_logits.numpy(),
                                   np.asarray(jout.clip_logits), atol=1e-3)
        np.testing.assert_array_equal(pout.correct.numpy(),
                                      np.asarray(jout.correct))
        np.testing.assert_array_equal(pout.zs_correct.numpy(),
                                      np.asarray(jout.zs_correct))
    assert_state_close(ps.method_state, js.method_state, 1e-4)
    assert ps.step == int(js.step) == 5
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jouts)
    assert pengine.summarize(pouts, 5) == jengine.summarize(stacked, 5)


def test_engine_matches_first_two_steps_with_residuals(pallas_interpret):
    """res_learning on: step 0 skips the Adam loop, step 1 runs its 10
    steps.  Logits of both steps within atol 1e-3.  The residuals after
    the loop are held in distribution, not per element: Adam's first steps
    move each element by ±lr whatever its gradient's size, so an element
    whose gradient is near zero takes either sign on a last-bit
    difference, and exp(exp(·)) in the loss spreads that over the next
    steps.  Half the elements agree within 1e-6 and nine in ten within
    2e-4 (residuals reach ~3e-3 here)."""
    for i, (js, jout, ps, pout) in enumerate(_run_both(True, steps=2)):
        np.testing.assert_allclose(pout.final_logits.numpy(),
                                   np.asarray(jout.final_logits), atol=1e-3)
        np.testing.assert_allclose(pout.clip_logits.numpy(),
                                   np.asarray(jout.clip_logits), atol=1e-3)
        d = np.abs(ps.res_state.residuals.numpy()
                   - np.asarray(js.res_state.residuals))
        assert np.median(d) < 1e-6 and np.quantile(d, 0.9) < 2e-4, (
            np.median(d), np.quantile(d, 0.9))
        assert ps.res_state.count == (0 if i == 0 else 10)
