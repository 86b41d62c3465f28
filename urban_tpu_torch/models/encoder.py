"""State encoders (counterpart of urban_tpu/models/encoder.py).

SGNNStateEncoder: message-passing GCN over the padded plan graph: node
embeddings are gathered to edges through a symmetrized edge MLP and
mean-aggregated back to nodes with a residual connection, then a
single-query attention of the current land use over all nodes. The
edge-to-node aggregation always goes through
``urban_tpu_torch.ops.segment_ops.segment_mean`` (the Hopper kernel on a
CUDA tensor); the gather is plain f32 indexing, with a gradient that
sums in a fixed order (``endpoint_rows``).

MLPStateEncoder: the ablation without message passing; each edge takes the
features of its feasible-side endpoint, and no segment mean runs.

Observation tuple layout (batched, B leading):
  numerical (B,F), nodes (B,N,Dn), edges (B,E,2) int32, current_node (B,Dn),
  node_mask (B,N) bool, edge_mask (B,E) bool, land_use_mask (B,E) bool,
  road_mask (B,N) bool, stage (B,3) float.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from urban_tpu_torch.host import city_config
from urban_tpu_torch.ops.segment_ops import segment_mean

EPSILON = 1e-6


class MLP(nn.Module):
    """Stacked Linear layers with tanh (the last one optional)."""

    def __init__(self, in_dim: int, features: Sequence[int],
                 activate_final: bool = True):
        super().__init__()
        dims = [in_dim, *features]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self.activate_final = activate_final

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1 or self.activate_final:
                x = torch.tanh(x)
        return x


def endpoint_rows(x, edges):
    """(B, E, D) rows of x (B, N, D) at each edge's first and second
    endpoint. One index into the flattened rows: its gradient is an
    index_put_ with accumulation, which sums a node's contributions in
    one fixed order on the card (sorted by index), where torch.gather's
    scatter_add_ adds them with atomics in an order that changes from run
    to run; the update must give the same bits each time it runs, and
    its captured graph the eager loop's."""
    b, n, d = x.shape
    ed = edges.long().clamp(0, n - 1)
    base = (torch.arange(b, device=x.device) * n)[:, None, None]
    rows = x.reshape(b * n, d)[ed + base]                   # (B, E, 2, D)
    return rows[..., 0, :], rows[..., 1, :]


def first_argmax(x):
    """Index of the first maximum along the last axis (jnp.argmax's rule
    on a tie), whatever the device's argmax does."""
    idx = torch.arange(x.shape[-1], device=x.device)
    top = x.amax(dim=-1, keepdim=True)
    return torch.where(x == top, idx, x.shape[-1]).amin(dim=-1)


def gather_to_edges(h_nodes, edges, edge_mask, edge_fc):
    """Per-edge embeddings from both endpoints through a symmetrized MLP."""
    h1, h2 = endpoint_rows(h_nodes, edges)
    h12 = torch.cat([h1, h2], dim=-1)
    h21 = torch.cat([h2, h1], dim=-1)
    h_edges = 0.5 * (edge_fc(h12) + edge_fc(h21))
    return torch.where(edge_mask[..., None], h_edges, 0.0)


def scatter_to_nodes(h_edges, edges, edge_mask, num_nodes):
    """Mean-aggregate edge embeddings back to their endpoints."""
    return segment_mean(h_edges.contiguous(), edges.contiguous(),
                        edge_mask.contiguous(), num_nodes)


def mean_features(h, mask):
    m = mask[..., None].to(h.dtype)
    return (h * m).sum(dim=-2) / torch.clamp_min(m.sum(dim=-2), EPSILON)


class MaskedAttention(nn.Module):
    """Multi-head attention of a single query over masked keys."""

    def __init__(self, dim: int, num_heads: int = 1):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, query, keys, values, mask):
        # query (B,1,D); keys/values (B,N,D); mask (B,N)
        h = self.num_heads
        dh = self.dim // h
        q = self.q(query).unflatten(-1, (h, dh))
        k = self.k(keys).unflatten(-1, (h, dh))
        v = self.v(values).unflatten(-1, (h, dh))
        logits = torch.einsum('bqhd,bnhd->bhqn', q, k) / math.sqrt(dh)
        logits = torch.where(mask[:, None, None, :], logits, -1e30)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum('bhqn,bnhd->bqhd', w, v).flatten(-2)
        return self.out(out)


class SGNNStateEncoder(nn.Module):
    def __init__(self, numerical_dim: int, node_dim: int,
                 hidden_size: Sequence[int], gcn_node_dim: int,
                 num_gcn_layers: int, num_edge_fc_layers: int,
                 num_attention_heads: int, max_num_nodes: int,
                 max_num_edges: int):
        super().__init__()
        self.gcn_node_dim = gcn_node_dim
        self.max_num_nodes = max_num_nodes
        self.max_num_edges = max_num_edges
        self.mlp = MLP(numerical_dim, hidden_size)
        self.node_encoder = nn.Linear(node_dim, gcn_node_dim)
        self.edge_fc = nn.ModuleList(
            MLP(2 * gcn_node_dim, [gcn_node_dim] * num_edge_fc_layers)
            for _ in range(num_gcn_layers))
        self.attention = MaskedAttention(gcn_node_dim, num_attention_heads)
        self.output_policy_land_use_size = gcn_node_dim * 4
        self.output_policy_road_size = gcn_node_dim
        self.output_value_size = gcn_node_dim * 3 + hidden_size[-1] + 3

    def forward(self, obs) -> Tuple:
        (numerical, nodes, edges, current_node, node_mask, edge_mask,
         land_use_mask, road_mask, stage) = obs
        h_numerical = self.mlp(numerical)
        h_nodes = self.node_encoder(nodes)
        h_current = self.node_encoder(current_node)[:, None, :]   # (B,1,D)

        h_edges = h_nodes.new_zeros(h_nodes.shape[0], self.max_num_edges,
                                    self.gcn_node_dim)
        for edge_fc in self.edge_fc:
            h_edges = gather_to_edges(h_nodes, edges, edge_mask, edge_fc)
            h_nodes = h_nodes + scatter_to_nodes(h_edges, edges, edge_mask,
                                                 self.max_num_nodes)

        h_edges_mean = mean_features(h_edges, edge_mask)
        h_nodes_mean = mean_features(h_nodes, node_mask)
        h_att = self.attention(h_current, h_nodes, h_nodes, node_mask)[:, 0]

        state_value = torch.cat(
            [h_numerical, h_nodes_mean, h_edges_mean, h_att, stage], dim=-1)
        h_cur_rep = h_current.expand(-1, self.max_num_edges, -1)
        state_policy_land_use = torch.cat(
            [h_edges, h_cur_rep, h_edges * h_cur_rep, h_edges - h_cur_rep],
            dim=-1)
        return (state_policy_land_use, h_nodes, state_value,
                land_use_mask, road_mask, stage)


class MLPStateEncoder(nn.Module):
    """No message passing: the edge features are the raw features of the
    edge's feasible-side endpoint, encoded by the same Linear as the
    nodes."""

    def __init__(self, numerical_dim: int, node_dim: int,
                 hidden_size: Sequence[int], gcn_node_dim: int,
                 max_num_nodes: int, max_num_edges: int):
        super().__init__()
        self.gcn_node_dim = gcn_node_dim
        self.max_num_nodes = max_num_nodes
        self.max_num_edges = max_num_edges
        self.mlp = MLP(numerical_dim, hidden_size)
        self.node_encoder = nn.Linear(node_dim, gcn_node_dim)
        self.output_policy_land_use_size = gcn_node_dim * 4
        self.output_policy_road_size = gcn_node_dim
        self.output_value_size = gcn_node_dim * 2 + hidden_size[-1] + 3

    def forward(self, obs) -> Tuple:
        (numerical, nodes, edges, current_node, node_mask, edge_mask,
         land_use_mask, road_mask, stage) = obs
        h_numerical = self.mlp(numerical)
        f1, f2 = endpoint_rows(nodes, edges)
        f2_feasible = first_argmax(
            f2[..., :city_config.NUM_TYPES + 1]) == city_config.FEASIBLE
        edge_features = torch.where(f2_feasible[..., None], f2, f1)
        edge_features = torch.where(edge_mask[..., None], edge_features, 0.0)

        h_nodes = self.node_encoder(nodes)
        h_edges = self.node_encoder(edge_features)
        h_current = self.node_encoder(current_node)[:, None, :]  # (B,1,D)

        h_edges_mean = mean_features(h_edges, edge_mask)
        h_nodes_mean = mean_features(h_nodes, node_mask)
        state_value = torch.cat(
            [h_numerical, h_nodes_mean, h_edges_mean, stage], dim=-1)
        h_cur_rep = h_current.expand(-1, self.max_num_edges, -1)
        state_policy_land_use = torch.cat(
            [h_edges, h_cur_rep, h_edges * h_cur_rep, h_edges - h_cur_rep],
            dim=-1)
        return (state_policy_land_use, h_nodes, state_value,
                land_use_mask, road_mask, stage)
