"""The port's point-tokenizer dVAE (`models/dvae.py`, `models/dvae_train.py`)
against the JAX package's on the CPU, narrow (8 groups of 8 points, 64
tokens; DGCNN's inner widths are fixed), the Gumbel noise injected from
the JAX draw: the forward, `chamfer_l1`, `dvae_loss`, one train step,
the schedules' endpoints, and an epoch against its loop."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uni_adapter_tpu.models.dvae as jdvae
import uni_adapter_tpu.models.dvae_train as jtrain
from uni_adapter_torch.models import dvae, dvae_train
from uni_adapter_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

WIDTHS = dict(num_group=8, group_size=8, encoder_dims=32, tokens_dims=16,
              decoder_dims=32, num_tokens=64)
B, NPTS = 2, 64


def rms_close(got, want, rtol, rms_frac):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rms_frac * np.sqrt(np.mean(want ** 2)))


@pytest.fixture(scope="module")
def case():
    """The JAX dVAE with perturbed params, a batch and the port's twin."""
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((B, NPTS, 3)).astype(np.float32)
    jmodel = jdvae.DiscreteVAE(**WIDTHS)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(pts),
                                  jax.random.PRNGKey(1))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
        .astype(np.float32), params)
    return jmodel, params, pts


def port_model(params):
    return dvae.create_dvae("cpu", state_dict=from_jax_params(params),
                            **WIDTHS)


@pytest.mark.parametrize("hard", [False, True])
def test_forward_matches_jax_on_the_jax_gumbel_draw(case, hard):
    jmodel, params, pts = case
    key = jax.random.PRNGKey(3)
    want = jmodel.apply({"params": params}, pts, key, temperature=0.5,
                        hard=hard)
    g = np.asarray(jax.random.gumbel(key, (B, WIDTHS["num_group"],
                                           WIDTHS["num_tokens"])))
    model = port_model(params)
    with torch.no_grad():
        got = model(torch.from_numpy(pts), temperature=torch.tensor(0.5),
                    hard=hard, gumbel=torch.from_numpy(g))
    for name, a, b in zip(("whole_coarse", "whole_fine", "coarse", "fine",
                           "neighborhood", "logits"), got, want):
        rms_close(a.numpy(), np.asarray(b), 1e-4, 1e-5)


def test_chamfer_and_loss_match_jax(case):
    jmodel, params, pts = case
    rng = np.random.default_rng(4)
    a = rng.standard_normal((3, 10, 3)).astype(np.float32)
    b = rng.standard_normal((3, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(
        dvae.chamfer_l1(torch.from_numpy(a), torch.from_numpy(b)).item(),
        float(jdvae.chamfer_l1(a, b)), rtol=1e-6)
    assert dvae.chamfer_l1(torch.from_numpy(a), torch.from_numpy(a)) == 0
    key = jax.random.PRNGKey(5)
    ret = jmodel.apply({"params": params}, pts, key)
    want = jdvae.dvae_loss(ret)
    got = dvae.dvae_loss(tuple(torch.from_numpy(np.asarray(r)) for r in ret))
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.item(), float(y), rtol=1e-5)


def test_one_train_step_matches_jax(case):
    """One `dvae_train_step` (no warmup: the first update has the peak
    lr): loss, recon, KL, the schedules and every updated parameter
    against JAX's on the same params and Gumbel draw."""
    jmodel, params, pts = case
    sched = jtrain.DVAESchedule(temp_anneal_steps=10, kl_warmup_steps=4)
    tx_j = jtrain.make_optimizer(lr=1e-3, total_steps=10, warmup_steps=0)
    state = jtrain.DVAETrainState(params, tx_j.init(params), jnp.int32(0))
    rng = jax.random.PRNGKey(7)
    new, jm = jtrain.dvae_train_step(jmodel, tx_j, sched, state, pts, rng)
    g = np.asarray(jax.random.gumbel(jax.random.fold_in(rng, 0), (
        B, WIDTHS["num_group"], WIDTHS["num_tokens"])))

    model = port_model(params)
    tx_p = dvae_train.make_optimizer(lr=1e-3, total_steps=10, warmup_steps=0)
    pstate = dvae_train.init_train_state(model, tx_p)
    psched = dvae_train.DVAESchedule(temp_anneal_steps=10, kl_warmup_steps=4)
    pstate, pm = dvae_train.dvae_train_step(
        model, tx_p, psched, pstate, torch.from_numpy(pts),
        gumbel=torch.from_numpy(g))
    assert pstate.step == 1 and pstate.opt_state.count == 1
    for k in ("loss", "recon", "kl", "temperature", "kl_weight"):
        np.testing.assert_allclose(pm[k].item(), float(jm[k]), rtol=1e-5)
    want = {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, new.params)).items()}
    assert set(want) == set(pstate.params)
    loose = total = 0
    for name, w in want.items():
        # the first AdamW step moves each weight by lr·g/(|g| + 1e-8) plus
        # its decay: ±lr wherever |g| ≫ 1e-8, so the two agree to the
        # step's rounding, except a weight whose gradient is at rounding
        # level in both, which either may move by up to lr
        got = pstate.params[name].detach().numpy().astype(np.float64)
        tol = 1e-5 * np.abs(w) + 1e-5 * np.sqrt(np.mean(w.astype(np.float64)
                                                        ** 2))
        d = np.abs(got - w)
        assert (d <= 2e-3 * (1 + np.abs(w))).all(), name
        loose += int((d > tol).sum())
        total += d.size
    assert loose <= 1e-3 * total, (loose, total)


def test_schedule_endpoints_match_jax():
    s = dvae_train.DVAESchedule()
    js = jtrain.DVAESchedule()
    for step in (0, 1, 5000, 10_000, 50_000, 100_000, 200_000):
        t, k = dvae_train.schedule_at(s, step)
        jt, jk = jtrain.schedule_at(js, jnp.int32(step))
        np.testing.assert_allclose(t.item(), float(jt), rtol=1e-6)
        np.testing.assert_allclose(k.item(), float(jk), rtol=1e-6)
    assert dvae_train.schedule_at(s, 0)[0].item() == 1.0
    np.testing.assert_allclose(dvae_train.schedule_at(s, 100_000)[0].item(),
                               0.0625, rtol=1e-6)
    assert dvae_train.schedule_at(s, 0)[1].item() == 0.0
    np.testing.assert_allclose(dvae_train.schedule_at(s, 10_000)[1].item(),
                               0.1, rtol=1e-6)


def test_train_epoch_equals_its_loop(case):
    """`train_epoch` over (T, B, N, 3) equals T `dvae_train_step`s drawing
    from the same generator, bit for bit."""
    _, params, pts = case
    sched = dvae_train.DVAESchedule(temp_anneal_steps=10, kl_warmup_steps=4)
    tx = dvae_train.make_optimizer(lr=1e-3, total_steps=10, warmup_steps=1)
    batches = torch.from_numpy(np.stack([pts, pts[::-1].copy(), pts]))
    a, b = port_model(params), port_model(params)
    sa = dvae_train.init_train_state(a, tx)
    sb = dvae_train.init_train_state(b, tx)
    sa, ma = dvae_train.train_epoch(a, tx, sched, sa, batches,
                                    torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(9)
    losses = []
    for batch in batches:
        sb, mb = dvae_train.dvae_train_step(b, tx, sched, sb, batch, gen)
        losses.append(mb["loss"])
    assert sa.step == sb.step == 3
    assert torch.equal(ma["loss"], torch.stack(losses))
    for name in sa.params:
        assert torch.equal(sa.params[name], sb.params[name])
    assert torch.isfinite(ma["loss"]).all() and ma["temperature"].shape == (3,)
