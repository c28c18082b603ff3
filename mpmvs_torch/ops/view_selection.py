"""Per-pixel source-view selection.

Counterpart of ``mpmvs_tpu.ops.view_selection``:
  1. initial top-k selection from per-view NCC costs, stored as a bitmask
     (ComputeMultiViewInitialCostandSelectedViews, PatchMatch.cu:497-534);
  2. per-iteration Monte-Carlo re-selection from candidate-cost statistics
     (CheckerboardPropagation, PatchMatch.cu:821-878), drawing its uniforms
     from an explicit threefry key.

Bitmasks live in int32 maps (<= 31 source views).
"""

from __future__ import annotations

import numpy as np
import torch

from mpmvs_torch.ops import threefry as tf

Tensor = torch.Tensor


def decode_bits(mask: Tensor, num_views: int) -> Tensor:
    """int mask (…) -> bool (…, V)."""
    bits = torch.arange(num_views, dtype=mask.dtype, device=mask.device)
    return ((mask[..., None] >> bits) & 1) > 0


def encode_bits(bits: Tensor) -> Tensor:
    """bool (…, V) -> int32 (…)."""
    V = bits.shape[-1]
    weights = 1 << torch.arange(V, dtype=torch.int32, device=bits.device)
    return torch.sum(bits.to(torch.int32) * weights, -1, dtype=torch.int32)


def initial_cost_and_views(costs: Tensor, top_k: int, cost_max: float = 2.0):
    """costs (S, H, W) -> (avg top-k cost (H, W), selected bitmask (H, W)).

    Keeps the ``min(num_valid, top_k)`` cheapest valid views; every view at
    or below the k-th smallest cost gets its bit (PatchMatch.cu:525-529).
    Pixels with no valid view cost ``cost_max`` with an empty mask."""
    S = costs.shape[0]
    c = torch.movedim(costs, 0, -1)  # (H, W, S)
    num_valid = torch.sum(c < cost_max, -1)
    k = torch.clamp(num_valid, max=top_k)
    sorted_c = torch.sort(c, -1).values
    csum = torch.cumsum(sorted_c, -1)
    k_idx = torch.clamp(k - 1, 0, S - 1)
    topk_sum = torch.gather(csum, -1, k_idx[..., None])[..., 0]
    threshold = torch.gather(sorted_c, -1, k_idx[..., None])[..., 0]
    has_any = k > 0
    cost = torch.where(has_any, topk_sum / torch.clamp(k, min=1),
                       torch.full_like(topk_sum, cost_max))
    selected = torch.where(has_any, encode_bits(c <= threshold[..., None]),
                           torch.zeros_like(k, dtype=torch.int32))
    return cost.to(costs.dtype), selected


def monte_carlo_view_weights(key: Tensor, cost_array: Tensor,
                             cand_valid: Tensor, neighbor_sel: Tensor,
                             neighbor_valid: Tensor, iteration: int,
                             num_samples: int = 15):
    """Per-pixel integer view weights via ``num_samples`` CDF draws
    (PatchMatch.cu:821-867): neighbour-bitmask priors (0.9/0.1), per-view
    good/bad counts over the 8 candidate costs with the decaying threshold
    0.8 exp(-iter^2/90), PDF -> CDF, inverse-CDF draws histogrammed into
    integer weights. Candidates without a valid source position are left out
    of the statistics (the JAX package's documented deviation).

    cost_array (8, S, H, W); cand_valid (8, H, W) bool; neighbor_sel
    (4, H, W) int; neighbor_valid (4, H, W) bool. Returns (view_weights
    (H, W, S) float, weight_norm (H, W), selected bitmask (H, W) int32)."""
    _, S, H, W = cost_array.shape
    c = torch.movedim(cost_array, 1, -1)          # (8, H, W, S)
    valid = cand_valid[..., None]                 # (8, H, W, 1)

    sel_bits = decode_bits(neighbor_sel, S)       # (4, H, W, S)
    prior_terms = torch.where(sel_bits, 0.9, 0.1).to(torch.float32)
    priors = torch.sum(torch.where(neighbor_valid[..., None], prior_terms,
                                   torch.zeros_like(prior_terms)), 0)

    it = torch.tensor(float(iteration), dtype=torch.float32, device=c.device)
    cost_threshold = 0.8 * torch.exp(it * it / -90.0)
    good = (c < cost_threshold) & valid
    bad = (c > 1.2) & valid
    count = torch.sum(good, 0).to(torch.float32)              # (H, W, S)
    count_false = torch.sum(bad, 0)
    tmpw = torch.sum(torch.where(good, torch.exp(c * c / -0.18),
                                 torch.zeros_like(c)), 0)

    probs = torch.where(
        (count > 2) & (count_false < 3),
        priors * tmpw / torch.clamp(count, min=1.0),
        torch.where(count_false < 3,
                    priors * torch.exp(cost_threshold * cost_threshold / -0.32),
                    torch.zeros_like(priors)))

    prob_sum = torch.sum(probs, -1, keepdim=True)
    any_prob = prob_sum[..., 0] > 0.0
    cdf = torch.cumsum(probs, -1) / torch.clamp(prob_sum, min=1e-30)
    cdf[..., -1] = 1.0

    us = tf.uniform(key, (num_samples, H, W))
    eps = float(np.finfo(np.float32).eps)
    views = torch.arange(S, device=c.device)
    weights = torch.zeros((H, W, S), dtype=torch.float32, device=c.device)
    for s in range(num_samples):
        u = us[s] - eps
        idx = torch.sum((cdf <= u[..., None]).to(torch.int32), -1)
        onehot = (idx[..., None] == views).to(torch.float32)
        weights = weights + torch.where(any_prob[..., None], onehot,
                                        torch.zeros_like(onehot))

    weight_norm = torch.sum(weights, -1)
    selected = encode_bits(weights > 0.0)
    return weights, weight_norm, selected
