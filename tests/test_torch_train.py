"""Contrastive pretraining in the port against the JAX package on the CPU:
the loss (`models/losses.py`), the fp32 EVA attention side's backward
(`ops/attention.EvaAttnBlockFunction` with its plain backward), the train
step's gradients at step 0, the AdamW arithmetic (`train.AdamW` against
optax), the decay mask, and a 12-step loss curve."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import uni_adapter_tpu.train as jtrain
from uni_adapter_tpu.models.common import EvaAttention as JaxEvaAttention
from uni_adapter_tpu.models.losses import (
    uni3d_text_image_loss as jax_loss)
from uni_adapter_tpu.models.uni3d import Uni3D as JaxUni3D
from uni_adapter_torch import train
from uni_adapter_torch.models.common import EvaAttention
from uni_adapter_torch.models.losses import uni3d_text_image_loss
from uni_adapter_torch.models.uni3d import Uni3D
from uni_adapter_torch.ops import attention, build
from uni_adapter_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

#: The small Uni3D of these tests: width 64, 4 heads, depth 2.
WIDTHS = dict(trans_dim=64, embed_dim=32, num_group=16, group_size=8,
              encoder_dim=32, depth=2, num_heads=4)
B, NPTS = 8, 128


def t(a, grad=False):
    return torch.from_numpy(np.asarray(a, np.float32).copy()).requires_grad_(
        grad)


def rms_close(got, want, rtol, rms_frac, scale=None):
    """|got − want| ≤ rtol·|want| + rms_frac·RMS(scale or want)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ref = want if scale is None else np.asarray(scale, np.float64)
    atol = rms_frac * np.sqrt(np.mean(ref ** 2))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# ------------------------------------------------------------------ loss


@pytest.mark.parametrize("masked", [False, True])
def test_loss_values_and_input_gradients_match_jax(masked):
    rng = np.random.default_rng(1)
    pc, tx, im = (rng.standard_normal((6, 16)).astype(np.float32)
                  for _ in range(3))
    scale = np.float32(8.5)
    mask = np.array([1, 0, 1, 1, 0, 1], np.float32) if masked else None

    def jf(pc, tx, im, s):
        out = jax_loss(pc, tx, im, s, mask=None if mask is None
                       else jnp.asarray(mask))
        return out["loss"], out

    (jl, jm), jg = jax.value_and_grad(jf, argnums=(0, 1, 2, 3),
                                      has_aux=True)(pc, tx, im, scale)
    args = [t(pc, True), t(tx, True), t(im, True), t(scale, True)]
    out = uni3d_text_image_loss(*args, mask=None if mask is None
                                else t(mask))
    pg = torch.autograd.grad(out["loss"], args)
    np.testing.assert_allclose(out["loss"].item(), float(jl), rtol=1e-5)
    for key in ("uni3d_loss", "pc_text_acc", "pc_image_acc"):
        np.testing.assert_allclose(out[key].item(), float(jm[key]),
                                   rtol=1e-5)
    for got, want in zip(pg, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


def test_loss_axis_name_waits_for_m16(tmp_path):
    """`axis_name` is a process group (the gathered loss at world 2:
    tests/test_torch_dp_train.py): in a world of one process it gives the
    loss, metrics and gradients of the plain loss, bitwise."""
    import torch.distributed as dist

    rng = np.random.default_rng(2)
    args = [t(rng.standard_normal((6, 16)), True) for _ in range(3)]
    mask = t(np.array([1, 0, 1, 1, 0, 1]))
    scale = torch.tensor(8.5)
    want = uni3d_text_image_loss(*args, scale, mask=mask)
    want_g = torch.autograd.grad(want["loss"], args)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        got = uni3d_text_image_loss(*args, scale, mask=mask,
                                    axis_name=dist.group.WORLD)
        got_g = torch.autograd.grad(got["loss"], args)
    finally:
        dist.destroy_process_group()
    for key in want:
        assert torch.equal(got[key], want[key]), key
    for g, w in zip(got_g, want_g):
        assert torch.equal(g, w)


# ---------------------------------------------------- attention backward


def attention_case(hd, seed=0):
    """A JAX EvaAttention's params (fp32, q/k LayerNorm γ near 2: peaked
    attention) and its input and output cotangent."""
    H, N = 4, 37
    D = H * hd
    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0: (std * rng.standard_normal(s)).astype(np.float32)
    params = {"q_proj": {"kernel": f(D, D, std=D ** -0.5), "bias": f(D, std=.1)},
              "k_proj": {"kernel": f(D, D, std=D ** -0.5)},
              "v_proj": {"kernel": f(D, D, std=D ** -0.5), "bias": f(D, std=.1)},
              "q_norm": {"scale": 2 + f(hd, std=.1), "bias": f(hd, std=.1)},
              "k_norm": {"scale": 2 + f(hd, std=.1), "bias": f(hd, std=.1)},
              "proj": {"kernel": f(D, D, std=D ** -0.5), "bias": f(D, std=.1)}}
    return H, D, params, f(2, N, D), f(2, N, D)


#: The port's parameter names in `eva_attn_block`'s argument order.
BLOCK_PARAMS = ("q_proj.weight", "q_proj.bias", "k_proj.weight",
                "v_proj.weight", "v_proj.bias", "q_norm.weight",
                "q_norm.bias", "k_norm.weight", "k_norm.bias", "proj.weight",
                "proj.bias")


def check_grads(got: dict, want: dict):
    """Every gradient within rtol 1e-4 + 1e-5 of its RMS.  dβk is zero but
    for rounding (softmax is invariant to one shift of every key): its
    scale is dγk's RMS, the same sum over the same rows."""
    for name, w in want.items():
        scale = want["k_norm.weight"] if name == "k_norm.bias" else None
        rms_close(got[name], w, 1e-4, 1e-5, scale)


@pytest.mark.parametrize("hd", [16, 64])
def test_block_backward_matches_autograd_and_jax(hd):
    """The twelve gradients of `EvaAttnBlockFunction` (on the CPU its plain
    backward) against autograd through `eva_attn_block_plain`, and against
    jax.grad of the JAX EvaAttention on its XLA path."""
    H, D, params, x, dy = attention_case(hd)
    jmod = JaxEvaAttention(D, H, dtype=jnp.float32)
    jgp, jgx = jax.grad(lambda p, x: jnp.sum(
        jmod.apply({"params": p}, x) * dy), argnums=(0, 1))(params, x)
    want = {"x": np.asarray(jgx), **{k: v.numpy() for k, v in
                                     from_jax_params(jgp).items()}}

    port = EvaAttention(D, H)
    port.load_state_dict(from_jax_params(params))
    xt = t(x, True)
    out = port(xt)
    assert type(out.grad_fn).__name__.startswith("EvaAttnBlockFunction")
    g = torch.autograd.grad(out, [xt, *port.parameters()], t(dy))
    got = dict(zip(["x", *(n for n, _ in port.named_parameters())],
                   (a.numpy() for a in g)))
    check_grads(got, want)

    ps = dict(port.named_parameters())
    args = [xt] + [ps[n] for n in BLOCK_PARAMS]
    plain = attention.eva_attn_block_plain(
        args[0], args[1], args[2], args[3], args[4], args[5], *args[6:10],
        args[10], args[11], num_heads=H, scale=hd ** -0.5)
    ga = torch.autograd.grad(plain, args, t(dy))
    by_autograd = dict(zip(["x", *BLOCK_PARAMS], (a.numpy() for a in ga)))
    check_grads(got, by_autograd)


def test_block_under_grad_forward_equals_plain_and_bf16_stays_plain():
    """Under autograd the fp32 block's forward is the plain version's bit
    for bit; a bf16 block on the CPU keeps the plain version's autograd."""
    H, D, params, x, _ = attention_case(16, seed=3)
    port = EvaAttention(D, H)
    port.load_state_dict(from_jax_params(params))
    xt = t(x, True)
    with torch.no_grad():
        frozen = port(xt)
    assert torch.equal(port(xt), frozen)
    port16 = port.to(torch.bfloat16)
    out = port16(xt.to(torch.bfloat16))
    assert "EvaAttnBlock" not in type(out.grad_fn).__name__


def test_plain_backward_parts_agree_with_autograd_of_each_step():
    """`attn_step_bwd_plain` and `head_ln_bwd_plain` each equal autograd of
    the forward step they differentiate (the split the kernels follow)."""
    rng = np.random.default_rng(5)
    Bt, N, H, hd = 2, 19, 2, 16
    D = H * hd
    raw = t(rng.standard_normal((Bt * N, 2 * D)), True)
    v = t(rng.standard_normal((Bt * N, D)), True)
    g = [t(2 + 0.1 * rng.standard_normal(hd), True) for _ in range(2)]
    b = [t(0.1 * rng.standard_normal(hd), True) for _ in range(2)]
    scale = hd ** -0.5

    def ln(x, gamma, beta):
        x = x.reshape(Bt * N, H, hd)
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return ((x - mu) * torch.rsqrt(var + 1e-5) * gamma + beta).reshape(
            Bt * N, D)

    q, k = ln(raw[:, :D], g[0], b[0]), ln(raw[:, D:], g[1], b[1])
    heads = lambda a: a.reshape(Bt, N, H, hd).transpose(1, 2)
    o = torch.softmax(torch.matmul(heads(q), heads(k).transpose(-1, -2))
                      * scale, -1) @ heads(v)
    attn = o.transpose(1, 2).reshape(Bt * N, D)
    dout = t(rng.standard_normal((Bt * N, D)))
    want = torch.autograd.grad(attn, [raw, v, *g, *b], dout)
    qkv = torch.cat([q, k, v], 1).detach()
    dqkv, dln = attention.eva_attn_block_bwd_plain(
        qkv, attn.detach(), dout, raw.detach(), g[0].detach(), g[1].detach(),
        Bt, N, H, scale, 1e-5)
    rms_close(dqkv[:, :2 * D].numpy(), want[0].numpy(), 1e-4, 1e-5)
    rms_close(dqkv[:, 2 * D:].numpy(), want[1].numpy(), 1e-4, 1e-5)
    for got, w in zip((dln[0], dln[2], dln[1]), (want[2], want[3], want[4])):
        rms_close(got.numpy(), w.numpy(), 1e-4, 1e-5)
    rms_close(dln[3].numpy(), want[5].numpy(), 0, 1e-5, dln[2].numpy())


def test_grad_guard_helper():
    """`build.require_no_grad`, which every value-returning kernel wrapper
    without a backward calls on the card: raises when grad mode is on and
    an input requires grad, passes otherwise."""
    x, y = torch.ones(2, requires_grad=True), torch.ones(2)
    assert build.needs_grad(x) and not build.needs_grad(y)
    build.require_no_grad("k", y)
    with pytest.raises(RuntimeError, match="k: the CUDA kernel has no "
                                           "backward"):
        build.require_no_grad("k", y, x)
    with torch.no_grad():
        assert not build.needs_grad(x)
        build.require_no_grad("k", x)


# ------------------------------------------------------------ train step


@pytest.fixture(scope="module")
def models():
    """The JAX Uni3D (fp32, XLA path) with perturbed params, the port's
    trainable twin, and one batch."""
    jmodel = JaxUni3D(**WIDTHS, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    pc = rng.standard_normal((B, NPTS, 6)).astype(np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(pc[:1]))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
        .astype(np.float32), params)
    batch = dict(pc=pc, text=rng.standard_normal((B, 32)).astype(np.float32),
                 image=rng.standard_normal((B, 32)).astype(np.float32),
                 mask=(rng.random(B) > 0.3).astype(np.float32))
    return jmodel, params, batch


def port_model(params):
    model = Uni3D(**WIDTHS, dtype=torch.float32)
    model.load_state_dict(from_jax_params(params))
    return model.requires_grad_(True)


def test_step0_loss_and_every_gradient_match_jax(models):
    """The loss and every parameter's gradient at step 0 against
    jax.value_and_grad of `train._loss_fn`, within rtol 1e-4 + 1e-5 of
    each gradient's RMS (worst err/tolerance 0.5 on this case)."""
    jmodel, params, b = models
    ls = np.float32(math.log(1 / 0.07))
    (jl, _), (jgp, jgs) = jax.jit(jax.value_and_grad(
        jtrain._loss_fn, argnums=(0, 1), has_aux=True), static_argnums=(2,))(
        params, jnp.float32(ls), jmodel, b["pc"], b["text"], b["image"],
        jnp.asarray(b["mask"]), None)
    model = port_model(params)
    state = train.init_train_state(model, train.make_optimizer())
    logit = state.logit_scale.requires_grad_(True)
    loss, _ = train._loss_fn(model, logit, t(b["pc"]), t(b["text"]),
                             t(b["image"]), t(b["mask"]))
    grads = torch.autograd.grad(loss, [*state.params.values(), logit])
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = {k: v.numpy() for k, v in from_jax_params(jgp).items()}
    assert set(want) == set(state.params)
    for name, g in zip(state.params, grads):
        scale = (want[name.replace("k_norm.bias", "k_norm.weight")]
                 if name.endswith("k_norm.bias") else None)
        rms_close(g.numpy(), want[name], 1e-4, 1e-5, scale)
    np.testing.assert_allclose(grads[-1].item(), float(jgs), rtol=1e-4)


def test_decay_mask_is_jax_mask_mapped():
    jmodel = JaxUni3D(**WIDTHS, dtype=jnp.float32)
    params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, NPTS, 6)))["params"]
    jmask, jscale = jtrain.decay_mask((params, 0.0))
    want = {k: bool(v) for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, jmask)).items()}
    got = train.decay_mask(Uni3D(**WIDTHS, dtype=torch.float32))
    assert got.pop(train.LOGIT_SCALE) is False and jscale is False
    assert got == want
    assert got["point_encoder.blocks.0.attn.q_proj.weight"]
    assert not got["point_encoder.blocks.0.attn.q_norm.weight"]
    assert not got["point_encoder.encoder.bn1.mean"]


def adam_leaves(opt_state):
    """(mu, nu, count) of optax's ScaleByAdamState inside a chain."""
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    (adam,) = found
    return adam.mu, adam.nu, int(adam.count)


@pytest.mark.parametrize("case", ["plain", "clipped", "clamped"])
def test_three_updates_match_optax(models, case):
    """Given the same gradients, three AdamW steps (clip, moments, bias
    correction, masked decay, warmup → cosine, the log-scale clamp) land
    the port's parameters and moments on optax's within 1e-6 relative."""
    jmodel, params, _ = models
    tx_j = jtrain.make_optimizer(lr=3e-2, weight_decay=0.05, total_steps=5,
                                 warmup_steps=1)
    tx_p = train.make_optimizer(lr=3e-2, weight_decay=0.05, total_steps=5,
                                warmup_steps=1)
    ls0 = 10.0 if case == "clamped" else math.log(1 / 0.07)
    jstate = jtrain.TrainState(params, jnp.float32(ls0),
                               tx_j.init((params, jnp.float32(ls0))),
                               jnp.int32(0))
    model = port_model(params)
    pstate = train.init_train_state(model, tx_p, ls0)
    mask = train.decay_mask(model)
    apply_grads = jax.jit(jtrain._apply_grads, static_argnums=(1,))
    rng = np.random.default_rng(7)
    big = 1e3 if case == "clipped" else 1e-2
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda a: (big * rng.standard_normal(np.shape(a))).astype(
                np.float32), params)
        gs = np.float32(big * rng.standard_normal())
        jstate = apply_grads(jstate, tx_j, (g, jnp.float32(gs)))
        pg = {**from_jax_params(g), train.LOGIT_SCALE: torch.tensor(gs)}
        pstate = train.apply_grads(pstate, tx_p, pg, mask)
    if case == "clipped":
        norm = math.sqrt(sum(float(np.sum(np.square(a))) for a in
                             jax.tree_util.tree_leaves(g)))
        assert norm > 10.0
    mu, nu, count = adam_leaves(jstate.opt_state)
    assert count == pstate.opt_state.count == pstate.step == 3
    for want_tree, got in ((jstate.params, pstate.params),
                           (mu[0], pstate.opt_state.mu),
                           (nu[0], pstate.opt_state.nu)):
        for name, w in from_jax_params(
                jax.tree_util.tree_map(np.asarray, want_tree)).items():
            rms_close(got[name].detach().numpy(), w.numpy(), 1e-6, 1e-6)
    np.testing.assert_allclose(pstate.logit_scale.item(),
                               float(jstate.logit_scale), rtol=1e-6)
    for j, p in ((mu[1], pstate.opt_state.mu), (nu[1], pstate.opt_state.nu)):
        np.testing.assert_allclose(p[train.LOGIT_SCALE].item(), float(j),
                                   rtol=1e-6)
    if case == "clamped":
        assert pstate.logit_scale.item() <= math.log(100.0) + 1e-6


def test_schedule_matches_optax():
    """The learning rate at every count within 1e-6 of optax's (the two
    libraries' fp32 cos can part by an ulp, which 1 + cos near its zero
    turns into ~3e-7 of the value)."""
    for total, warmup in ((20, 5), (3, 0), (10, 10)):
        sched = optax.warmup_cosine_decay_schedule(
            0.0, 1e-3, warmup, max(total, warmup + 1))
        tx = train.make_optimizer(lr=1e-3, total_steps=total,
                                  warmup_steps=warmup)
        for count in range(total + 3):
            np.testing.assert_allclose(tx.schedule(count),
                                       float(sched(count)), rtol=1e-6,
                                       err_msg=str((total, count)))


#: The 12-step loss curves may part by this much: the two frameworks'
#: fp32 sums differ in their last bits, and Adam's first steps (m̂/√v̂,
#: ±lr for every coordinate whatever the gradient's size) carry that
#: into the parameters; measured on this case, |Δloss| ≤ 7.7e-5 while the
#: loss falls from 6.31 to 5.60.
CURVE_ATOL = 1e-3


def test_twelve_step_loss_curve_tracks_jax(models):
    """Multi-step trajectories are Adam-chaotic, so the curve is held in
    distribution: every step's loss within CURVE_ATOL of JAX's."""
    jmodel, params, b = models
    tx_j = jtrain.make_optimizer(lr=1e-3, total_steps=12, warmup_steps=2)
    tx_p = train.make_optimizer(lr=1e-3, total_steps=12, warmup_steps=2)
    jstate = jtrain.TrainState(
        params, jnp.float32(math.log(1 / 0.07)),
        tx_j.init((params, jnp.float32(math.log(1 / 0.07)))), jnp.int32(0))
    model = port_model(params)
    pstate = train.init_train_state(model, tx_p)
    rng = np.random.default_rng(11)
    jl, pl = [], []
    for _ in range(12):
        pc = rng.standard_normal((B, NPTS, 6)).astype(np.float32)
        tx_, im = (rng.standard_normal((B, 32)).astype(np.float32)
                   for _ in range(2))
        jstate, jm = jtrain.train_step(jmodel, tx_j, jstate, pc, tx_, im,
                                       jnp.asarray(b["mask"]))
        pstate, pm = train.train_step(model, tx_p, pstate, t(pc), t(tx_),
                                      t(im), t(b["mask"]))
        jl.append(float(jm["loss"]))
        pl.append(pm["loss"].item())
    np.testing.assert_allclose(pl, jl, atol=CURVE_ATOL)
