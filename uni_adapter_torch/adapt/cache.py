"""The Uni-Adapter prototype cache with graph-Laplacian label refinement
(mirror of `uni_adapter_tpu/adapt/cache.py`).

The cache holds at most `shot_capacity` prototypes a class as
fixed-capacity tensors and a validity mask:

    feats  ([S,] K, C, D)   prototype features
    conf   ([S,] K, C)      confidences exp(-β·normalised entropy)
    probs  ([S,] K, C, K)   per-prototype class probabilities
    counts ([S,] K, C)      merge counts
    valid  ([S,] K, C)      slot occupancy

One sample a step (the reference's protocol is batch 1).  The JAX
`lax.cond` insert-or-merge is branchless here: both candidates are
computed and `torch.where` picks, with no read back to the host.  S
independent streams carry a leading (S,) axis on every tensor (the JAX
package's `jax.vmap`).  Every update returns new tensors; the old state
is left as it was.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from uni_adapter_torch.utils import math as umath
from uni_adapter_torch.utils.math import (normalized_entropy, refined_labels,
                                          refinement_system, softmax_entropy,
                                          solve_explicit)


class CacheState(NamedTuple):
    feats: torch.Tensor    # ([S,] K, C, D)
    conf: torch.Tensor     # ([S,] K, C)
    probs: torch.Tensor    # ([S,] K, C, K)
    counts: torch.Tensor   # ([S,] K, C)
    valid: torch.Tensor    # ([S,] K, C) bool


def init(num_classes: int, shot_capacity: int, feat_dim: int,
         device=None) -> CacheState:
    K, C, D = num_classes, shot_capacity, feat_dim
    z = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                               device=device)
    return CacheState(z(K, C, D), z(K, C), z(K, C, K), z(K, C),
                      torch.zeros(K, C, dtype=torch.bool, device=device))


def merge_slot(sims: torch.Tensor) -> torch.Tensor:
    """The prototype a full class merges into: the most similar, the first
    on ties.  sims (L, C) -> (L,)."""
    return torch.argmax(sims, dim=-1)


def update_cache(state: CacheState, pred: torch.Tensor,
                 pc_features: torch.Tensor, prop_entropy: torch.Tensor,
                 prob_map: torch.Tensor, clip_weights: torch.Tensor,
                 beta: float = 150.0, logit_scale: float = 100.0):
    """Insert-or-merge one sample a stream.

    Args:
      pred: ([S,]) int predicted class.
      pc_features: ([S,] 1, D) L2-normalised feature.
      prop_entropy: ([S,]) normalised entropy of the sample's logits.
      prob_map: ([S,] 1, K) softmax probabilities.
      clip_weights: ([S,] D, K) current text anchors.
      logit_scale: the scale of the engine's clip logits, used when a merge
        re-scores the merged prototype.
    Returns:
      (new state, inserted ([S,]) bool: True for an insert, False for a
      merge).

    A class with room takes the sample in its next slot (slots fill in
    order and are never freed).  A full class merges it into its most
    similar prototype by a confidence·count-weighted mean, renormalised;
    where both confidences underflowed to 0 (the 0/0 of the reference's
    formula) by the count-weighted mean instead.
    """
    lead = pred.shape
    K, C, D = state.feats.shape[-3:]
    feats, conf, probs, counts, valid = (
        t.reshape(-1, *t.shape[len(lead):]) for t in state)
    L = feats.shape[0]
    li = torch.arange(L, device=feats.device)
    cls = pred.reshape(L).long()
    feat = pc_features.reshape(L, -1, D)[:, 0].to(torch.float32)     # (L, D)
    confidence = torch.exp(-beta * prop_entropy.reshape(L))
    n_valid = valid[li, cls].sum(dim=-1)                              # (L,)
    has_room = n_valid < C

    # the merge candidate (used only where the class is full)
    row = feats[li, cls]                                              # (L, C, D)
    m = merge_slot(torch.matmul(row, feat[:, :, None])[..., 0])
    feat_c = row[li, m]
    conf_c = conf[li, cls, m]
    count_c = counts[li, cls, m]
    denom = count_c * conf_c + confidence
    weighted = ((conf_c * count_c)[:, None] * feat_c
                + confidence[:, None] * feat) / torch.where(
                    denom > 0.0, denom, 1.0)[:, None]
    new_feat = torch.where((denom > 0.0)[:, None], weighted,
                           (count_c[:, None] * feat_c + feat)
                           / (count_c + 1.0)[:, None])
    new_feat = new_feat / (torch.linalg.norm(new_feat, dim=-1, keepdim=True)
                           + 1e-12)
    w = clip_weights.reshape(-1, *clip_weights.shape[-2:])
    logits = logit_scale * torch.matmul(new_feat[:, None, :], w)[:, 0]
    new_prob = torch.softmax(logits, dim=-1)
    new_conf = torch.exp(-beta * normalized_entropy(softmax_entropy(logits),
                                                    K))

    slot = torch.where(has_room, n_valid, m)
    room = has_room[:, None]
    idx = (li, cls, slot)
    out = CacheState(
        feats.index_put(idx, torch.where(room, feat, new_feat)),
        conf.index_put(idx, torch.where(has_room, confidence, new_conf)),
        probs.index_put(idx, torch.where(
            room, prob_map.reshape(L, -1, K)[:, 0].to(torch.float32),
            new_prob)),
        counts.index_put(idx, torch.where(has_room, 1.0, count_c + 1.0)),
        valid.index_put(idx, torch.ones_like(has_room)))
    return (CacheState(*(t.reshape(*lead, *t.shape[1:]) for t in out)),
            has_room.reshape(lead))


class GraphSystem(NamedTuple):
    """The refinement graph and its linear system."""
    nodes: torch.Tensor    # ([S,] N, D)
    valid: torch.Tensor    # ([S,] N)
    L: torch.Tensor        # ([S,] N, N) regularised Laplacian
    rhs: torch.Tensor      # ([S,] N, K)


class Refinement(NamedTuple):
    """A refinement under way: the graph's system, the CG's carry (None:
    the explicit solve) and the solution (the CG's x, updated in place)."""
    graph: GraphSystem
    cg: Optional[umath.CGState]
    sol: torch.Tensor


def start_refinement(state: CacheState, threshold: float, lambda_reg: float,
                     use_new_approximation: bool = True,
                     graph_mode: str = "dense") -> Refinement:
    """The first part of `compute_cache_logits`: the graph of `graph_mode`,
    the system its refinement solves, and the CG's start (or the explicit
    solve)."""
    nodes, node_probs, node_valid = graph_nodes(state, graph_mode)
    graph = GraphSystem(nodes, node_valid, *refinement_system(
        nodes, node_probs, node_valid, threshold, lambda_reg))
    if use_new_approximation:
        cg = umath.cg_start(graph.rhs)
        return Refinement(graph, cg, cg.x)
    return Refinement(graph, None, solve_explicit(graph.L, graph.rhs))


def refinement_iteration(ref: Refinement) -> torch.Tensor:
    """The second part, run until every system has stopped: one CG
    iteration in place, at the CG's default tolerance as the JAX engine
    runs it; returns whether every system has stopped."""
    return umath.cg_iteration_(ref.graph.L, ref.cg)


def graph_readout(pc_features: torch.Tensor,
                  ref: Refinement) -> torch.Tensor:
    """The last part: the solution's refined labels → one-hot →
    count-normalised → affinity readout at the features, ([S,] B, K),
    shared by both graph modes."""
    graph = ref.graph
    refined = refined_labels(ref.sol, graph.valid)
    node_valid = graph.valid[..., None].to(torch.float32)
    values = torch.nn.functional.one_hot(torch.argmax(refined, dim=-1),
                                         refined.shape[-1]).to(torch.float32)
    values = values * node_valid
    values = values / (values.sum(dim=-2, keepdim=True) + 1e-6)
    pc = pc_features / (torch.linalg.norm(pc_features, dim=-1, keepdim=True)
                        + 1e-12)
    affinity = torch.matmul(pc.to(torch.float32),
                            graph.nodes.transpose(-1, -2))
    affinity = affinity * node_valid.transpose(-1, -2)
    return torch.matmul(affinity, values)


def compute_cache_logits(pc_features: torch.Tensor, state: CacheState,
                         threshold: float, lambda_reg: float,
                         use_new_approximation: bool = True,
                         cg_max_iter: int = 100, graph_mode: str = "dense"):
    """Cache logits with graph-based label smoothing: `start_refinement`,
    `refinement_iteration` until every system has stopped (the host reads
    the stop flags after each), `graph_readout`, the parts that the
    engine's cache step runs.

    graph_mode "dense" (the reference's): the K·C slots are the graph's
    nodes; "prototype": each class's valid shots collapse into one
    confidence-weighted prototype and the graph has K nodes (the dense
    graph at Objaverse-LVIS scale does not fit); "auto": dense while
    K·C ≤ 4096, prototype above.  `use_new_approximation` refines by CG,
    else by the explicit solve.

    Args:
      pc_features: ([S,] B, D).
    Returns:
      (([S,] B, K) cache logits, zeros while the cache is empty;
       the CG's iterations ([S,]), None for the explicit solve).
    """
    ref = start_refinement(state, threshold, lambda_reg,
                           use_new_approximation, graph_mode)
    if ref.cg is None:
        return graph_readout(pc_features, ref), None
    umath.run_cg(lambda: refinement_iteration(ref), cg_max_iter)
    return graph_readout(pc_features, ref), ref.cg.iters


def graph_nodes(state: CacheState, graph_mode: str = "dense"):
    """The refinement graph of `compute_cache_logits`'s `graph_mode`: its
    nodes' features ([S,] N, D), probabilities ([S,] N, K) and validity
    ([S,] N), N = K·C (dense) or K (prototype)."""
    K, C, D = state.feats.shape[-3:]
    lead = state.feats.shape[:-3]
    if graph_mode == "auto":
        graph_mode = "dense" if K * C <= 4096 else "prototype"
    if graph_mode == "prototype":
        return _class_prototypes(state)
    if graph_mode == "dense":
        return (state.feats.reshape(*lead, K * C, D),
                state.probs.reshape(*lead, K * C, K),
                state.valid.reshape(*lead, K * C))
    raise ValueError(f"unknown graph_mode {graph_mode!r} "
                     "(expected 'auto', 'dense', or 'prototype')")


def _class_prototypes(state: CacheState):
    """One node a class: the confidence-weighted mean of its valid shots
    (renormalised) and of their probabilities.  A class whose confidences
    all underflowed to 0 takes the plain mean of its valid shots; the
    weights are normalised before the reductions, so tiny nonzero
    confidences keep their class.  Returns (K, D) nodes, (K, K) probs and
    (K,) validity, each with the state's leading axis."""
    vmask = state.valid.to(torch.float32)
    w = state.conf * vmask                                           # (K, C)
    w = torch.where(w.sum(dim=-1, keepdim=True) > 0.0, w, vmask)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-30)
    proto = torch.matmul(w[..., None, :], state.feats)[..., 0, :]
    proto = proto / (torch.linalg.norm(proto, dim=-1, keepdim=True) + 1e-12)
    proto_probs = torch.matmul(w[..., None, :], state.probs)[..., 0, :]
    return proto, proto_probs, state.valid.any(dim=-1)
