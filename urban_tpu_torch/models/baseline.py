"""The GA baseline's gene-scored linear policy on batched slot-layout
observations (counterpart of urban_tpu/models/baseline.py:196-230,
``ga_logits_jax``). The numpy baselines themselves are the host copy,
``urban_tpu_torch.host.models.baseline``."""
from __future__ import annotations

from typing import Tuple

import torch

from urban_tpu_torch.host import city_config

_XY = slice(city_config.NUM_TYPES + 1, city_config.NUM_TYPES + 3)


def ga_logits(obs, gene: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAPolicy's linear gene scoring for a population: observation p
    (build_obs, batched over P) scored by gene p (P, G). Returns the
    land-use logits (P, E) and the road logits (P, N); the caller masks
    them and takes the argmax or samples. An edge scores the mean of its
    endpoints' features and the mean distance of its midpoint to the
    alive nodes of the current land-use type (0 where there is none)
    with the first G // 2 + 1 genes; a node scores its features with the
    rest. Masked slots take the row's least logit less one."""
    nodes, edges, cur = obs[1], obs[2], obs[3]
    node_mask, edge_mask = obs[4], obs[5]
    half = gene.shape[-1] // 2 + 1

    def at(x, i):   # x (P, N, F) at node indices i (P, E) -> (P, E, F)
        return torch.gather(x, 1, i.long()[..., None].expand(
            -1, -1, x.shape[-1]))
    f1, f2 = at(nodes, edges[..., 0]), at(nodes, edges[..., 1])
    ef = 0.5 * (f1 + f2)
    exy = 0.5 * (f1[..., _XY] + f2[..., _XY])
    xy = nodes[..., _XY]
    cur_type = torch.argmax(cur[:, :city_config.NUM_TYPES + 1], dim=-1)
    same = node_mask & (torch.gather(
        nodes, 2, cur_type[:, None, None].expand(-1, nodes.shape[1], 1)
    )[..., 0] == 1.0)
    n_same = same.sum(dim=-1, keepdim=True)
    # the distances to all N nodes, those of other types masked out (JAX's
    # form): a static shape, without the host sync that cutting them to
    # the nodes of the type would need, so that a CUDA graph holds it
    dx = exy[:, :, None, 0] - xy[:, None, :, 0]
    dy = exy[:, :, None, 1] - xy[:, None, :, 1]
    d = torch.sqrt(dx * dx + dy * dy)                          # (P, E, N)
    dist_same = torch.where(
        n_same > 0,
        torch.where(same[:, None, :], d, 0.0).sum(dim=-1)
        / torch.clamp_min(n_same, 1), 0.0)
    ef = torch.cat([ef, dist_same[..., None]], dim=-1)
    lu = (ef * gene[:, None, :half]).sum(dim=-1)
    lu = torch.where(edge_mask, lu, lu.amin(dim=-1, keepdim=True) - 1.0)
    rd = (nodes * gene[:, None, half:]).sum(dim=-1)
    rd = torch.where(node_mask, rd, rd.amin(dim=-1, keepdim=True) - 1.0)
    return lu, rd
