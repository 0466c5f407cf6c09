"""Structured synthetic streams where test-time adaptation provably helps
(mirror of `uni_adapter_tpu/data/synthetic_stream.py`): the toy problems
of the JAX package's efficacy tests, numpy for the data and the port's
engine for the adapters.

K classes on a tight ring around a base axis in a toy encoder's 3-D
input space, text anchors built from the clean class means, then the
whole ring rotated toward its neighbours by ROT × the class spacing (a
systematic misalignment whose soft labels stay right on average) plus
per-sample jitter; and, at realistic label-set scale, K class means
near-uniform on the sphere under one global rotation
(`make_problem_sphere`).  The arrays are the JAX package's, bit for bit,
from the same seed.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from uni_adapter_torch.config import (CacheConfig, Config, DotaConfig,
                                      ModelConfig)

K, D, N, T = 8, 32, 64, 480
DELTA, ROT, JITTER, TAU = 0.20, 0.38, 0.12, 0.03


def make_problem(seed: int, steps: int = T):
    """Build one stream.

    Returns (pcs (steps,1,N,3), targets (steps,1) int64, text (K,D) unit
    rows, W (3,D) — the toy encoder's lift matrix)."""
    rng = np.random.default_rng(seed)
    e0 = np.array([1.0, 0.0, 0.0], np.float32)
    spacing = 2 * np.pi / K
    ang = spacing * np.arange(K)

    def ring_points(angles):
        r = np.stack([np.zeros(len(angles)), np.cos(angles),
                      np.sin(angles)], 1).astype(np.float32)
        m = e0[None] + DELTA * r
        return m / np.linalg.norm(m, axis=1, keepdims=True)

    m_clean = ring_points(ang)
    m_corrupt = ring_points(ang + ROT * spacing)
    W = rng.standard_normal((3, D)).astype(np.float32)
    text = np.sin(m_clean) @ W
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    y = rng.integers(0, K, (steps, 1)).astype(np.int64)
    centers = m_corrupt[y[:, 0]] \
        + JITTER * DELTA * rng.standard_normal((steps, 3)).astype(np.float32)
    pcs = centers[:, None, None, :] + TAU * rng.standard_normal(
        (steps, 1, N, 3)).astype(np.float32)
    return pcs.astype(np.float32), y, text.astype(np.float32), W


def zero_shot_acc(pcs, targets, text, W) -> float:
    """Implementation-independent zero-shot accuracy: the frozen-anchor
    baseline (features are deterministic in the toy encoder, so this is
    THE zero-shot number for the stream)."""
    feat = np.sin(pcs[:, 0]).mean(axis=1) @ W                # (T, D)
    feat /= np.linalg.norm(feat, axis=1, keepdims=True)
    pred = (feat @ text.T).argmax(axis=1)
    return float(100.0 * np.mean(pred == targets[:, 0]))


class ToyEncoder(nn.Module):
    """Deterministic toy encoder: sin → mean-pool → linear lift (of the
    xyz channels of the (B, N, 6) clouds the engine gives Uni3D)."""

    def __init__(self, W):
        super().__init__()
        self.register_buffer("W", torch.as_tensor(np.asarray(W)))

    def forward(self, pc: torch.Tensor) -> torch.Tensor:
        return (torch.sin(pc[:, :, :3]).mean(dim=1) @ self.W).to(
            torch.float32)


def method_config(method: str) -> Config:
    """The reference's default hyperparameters per adapter, residual
    learning off for MODE-DOTA (the JAX package's toy-scale choice)."""
    dc = {
        "mode": DotaConfig(use_mode_dota=True, mode_M=4, res_learning=False,
                           epsilon=1e-4, sigma=1e-4, rho=0.02, eta=0.1,
                           noise_std=0.0, fp16_predict_input=True),
        "cache": DotaConfig(use_dota=False, use_mode_dota=False),
        "gmm": DotaConfig(use_dota=False, use_mode_dota=False,
                          use_gmm_dota=True, mode_M=4,
                          epsilon=1e-4, sigma=1e-4, rho=0.02, eta=0.1),
    }[method]
    return Config(model=ModelConfig(compute_dtype="float32"), dota=dc,
                  cache=CacheConfig(shot_capacity=30, threshold=0.5,
                                    lambda_reg=0.11, beta=150.0))


def run_adapter(method: str, text, pcs, targets, W, device="cpu"):
    """Run one adapter over the stream through the engine's scan.

    Returns (accuracy %, per-step final logits (T, K))."""
    from uni_adapter_torch import engine

    cfg = method_config(method)
    model = ToyEncoder(W).to(device)
    rgbs = np.ones_like(pcs)
    _, outs = engine.run_stream_scan(
        cfg, model, torch.as_tensor(text, device=device), pcs, rgbs,
        targets.astype(np.int64))
    final = outs.final_logits[:, 0].cpu().numpy()
    acc = float(100.0 * np.mean(final.argmax(-1) == targets[:, 0]))
    return acc, final


# ---------------------------------------------------------------------------
# Realistic-dims sphere stream (round-5): K=40+ classes, D=512-1024
# ---------------------------------------------------------------------------

def _fibonacci_sphere(K: int) -> np.ndarray:
    """K near-uniform unit vectors on S² (golden-angle spiral)."""
    i = np.arange(K, dtype=np.float64) + 0.5
    phi = np.arccos(1 - 2 * i / K)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return np.stack([np.cos(theta) * np.sin(phi),
                     np.sin(theta) * np.sin(phi),
                     np.cos(phi)], 1).astype(np.float32)


def _rotation(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / np.linalg.norm(axis)
    a, b, c = axis
    Kx = np.array([[0, -c, b], [c, 0, -a], [-b, a, 0]], np.float64)
    return (np.eye(3) + np.sin(angle) * Kx
            + (1 - np.cos(angle)) * (Kx @ Kx)).astype(np.float32)


def nn_spacing(means: np.ndarray) -> float:
    """Mean nearest-neighbour angle of a set of unit vectors."""
    G = means @ means.T
    np.fill_diagonal(G, -2.0)
    return float(np.mean(np.arccos(np.clip(G.max(1), -1, 1))))


def make_problem_sphere(seed: int, K: int = 40, D: int = 512, N: int = 64,
                        T: int = 480, theta_frac: float = 0.55,
                        jitter: float = 0.12, tau: float = 0.03):
    """Recoverable-drift stream at REALISTIC label-set scale.

    The ring construction above degenerates past K≈8 (a 1-D ring in the
    encoder's 3-d input space gets too crowded; zero-shot collapses below
    50%).  Here the K class means sit near-uniformly on the full sphere
    (each class has ~6 nearest neighbours — the crowded-confusion
    geometry of a real K=40 label set), and the corruption is ONE
    coherent global rotation by theta_frac × the mean nearest-neighbour
    spacing: every anchor becomes systematically misplaced by the same
    transform (the recoverable-shift regime, Uni_Adapter.py:581-595),
    plus per-sample center jitter and point noise.

    Returns (pcs (T,1,N,3), targets (T,1) int64, text (K,D) unit rows,
    W (3,D))."""
    rng = np.random.default_rng(seed)
    m_clean = _fibonacci_sphere(K)
    sp = nn_spacing(m_clean)
    R = _rotation(rng.standard_normal(3), theta_frac * sp)
    m_corrupt = m_clean @ R.T
    W = rng.standard_normal((3, D)).astype(np.float32)
    text = np.sin(m_clean) @ W
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    y = rng.integers(0, K, (T, 1)).astype(np.int64)
    centers = m_corrupt[y[:, 0]] \
        + jitter * sp * rng.standard_normal((T, 3)).astype(np.float32)
    pcs = centers[:, None, None, :] + tau * rng.standard_normal(
        (T, 1, N, 3)).astype(np.float32)
    return pcs.astype(np.float32), y, text.astype(np.float32), W
