"""Shared-trunk actor-critic (counterpart of urban_tpu/models/model.py).

The SGNN encoder, both policy heads and the value head live in one module;
``sample_action_logp_value`` runs the trunk once per rollout step.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from urban_tpu_torch.host import city_config
from urban_tpu_torch.models.encoder import SGNNStateEncoder
from urban_tpu_torch.models.policy import (PolicyHead, categorical_entropy,
                                           categorical_log_prob,
                                           categorical_sample, masked_logits)

# observation widths (urban_tpu_torch.torchenv.step.build_obs)
NODE_DIM = city_config.NUM_TYPES + 1 + 2 + 4 + 3     # one-hot, xy, sizes, shape
NUMERICAL_DIM = 4 * city_config.NUM_TYPES            # ratios + counts, req + now


class ActorCritic(nn.Module):
    def __init__(self, hidden_size: Sequence[int], gcn_node_dim: int,
                 num_gcn_layers: int, num_edge_fc_layers: int,
                 num_attention_heads: int, max_num_nodes: int,
                 max_num_edges: int, land_use_hidden: Sequence[int],
                 road_hidden: Sequence[int], value_hidden: Sequence[int],
                 numerical_dim: int = NUMERICAL_DIM, node_dim: int = NODE_DIM):
        super().__init__()
        self.num_gcn_layers = num_gcn_layers
        self.shared_net = SGNNStateEncoder(
            numerical_dim, node_dim, hidden_size, gcn_node_dim,
            num_gcn_layers, num_edge_fc_layers, num_attention_heads,
            max_num_nodes, max_num_edges)
        sn = self.shared_net
        self.land_use_head = PolicyHead(sn.output_policy_land_use_size,
                                        land_use_hidden)
        self.road_head = PolicyHead(sn.output_policy_road_size, road_hidden)
        dims = [sn.output_value_size, *value_hidden]
        self.value_mlp = nn.ModuleList(nn.Linear(a, b)
                                       for a, b in zip(dims[:-1], dims[1:]))

    def _trunk(self, obs):
        (state_lu, state_road, state_value, land_use_mask, road_mask,
         stage) = self.shared_net(obs)
        lu_logits = masked_logits(self.land_use_head(state_lu), land_use_mask)
        road_logits = masked_logits(self.road_head(state_road), road_mask)
        x = state_value
        for i, layer in enumerate(self.value_mlp):
            x = layer(x)
            if i < len(self.value_mlp) - 1:
                x = torch.tanh(x)
        return lu_logits, road_logits, stage, x

    def forward(self, obs):
        return self._trunk(obs)

    def value(self, obs):
        return self._trunk(obs)[3]

    @staticmethod
    def _stage_action(stage, lu_action, road_action):
        """(B, 2) slot action: the head of the current stage, 0 elsewhere."""
        in_lu = stage[..., 0] > 0.5
        in_road = stage[..., 1] > 0.5
        return torch.stack([torch.where(in_lu, lu_action, 0),
                            torch.where(in_road, road_action, 0)],
                           dim=-1).to(torch.int32)

    @staticmethod
    def _mixed_action(lu_logits, road_logits, stage, generator, use_mean):
        lu_sample = categorical_sample(lu_logits, generator)
        road_sample = categorical_sample(road_logits, generator)
        lu_action = torch.where(use_mean, torch.argmax(lu_logits, dim=-1),
                                lu_sample)
        road_action = torch.where(use_mean, torch.argmax(road_logits, dim=-1),
                                  road_sample)
        return ActorCritic._stage_action(stage, lu_action, road_action)

    @staticmethod
    def _stage_select(stage, lu_x, road_x):
        in_lu = stage[..., 0] > 0.5
        in_road = stage[..., 1] > 0.5
        return torch.where(in_lu, lu_x, torch.where(in_road, road_x, 0.0))

    def select_action(self, obs, generator: torch.Generator,
                      mean_action: bool = False):
        """(B, 2) action: sampled, or the argmax with mean_action (which
        draws nothing from the generator)."""
        lu_logits, road_logits, stage, _ = self._trunk(obs)
        if mean_action:
            return self._stage_action(stage, torch.argmax(lu_logits, dim=-1),
                                      torch.argmax(road_logits, dim=-1))
        return self._stage_action(stage,
                                  categorical_sample(lu_logits, generator),
                                  categorical_sample(road_logits, generator))

    def select_action_mixed(self, obs, generator: torch.Generator,
                            use_mean: torch.Tensor):
        """Per-row choice between sampling and the argmax (noise-rate
        control)."""
        lu_logits, road_logits, stage, _ = self._trunk(obs)
        return self._mixed_action(lu_logits, road_logits, stage, generator,
                                  use_mean)

    def sample_action_logp_value(self, obs, generator: torch.Generator,
                                 use_mean: torch.Tensor) -> Tuple:
        """One trunk pass for rollouts: the action (B, 2) (sampled, or the
        argmax where use_mean), its log-prob (B, 1) and the value (B, 1)."""
        lu_logits, road_logits, stage, value = self._trunk(obs)
        action = self._mixed_action(lu_logits, road_logits, stage, generator,
                                    use_mean)
        log_prob = self._stage_select(
            stage, categorical_log_prob(lu_logits, action[..., 0]),
            categorical_log_prob(road_logits, action[..., 1]))
        return action, log_prob[..., None], value

    def log_prob_entropy_value(self, obs, action) -> Tuple:
        """One trunk pass serving the whole PPO loss: log-prob, entropy and
        value, each (B, 1)."""
        lu_logits, road_logits, stage, value = self._trunk(obs)
        log_prob = self._stage_select(
            stage, categorical_log_prob(lu_logits, action[..., 0]),
            categorical_log_prob(road_logits, action[..., 1]))
        entropy = self._stage_select(stage, categorical_entropy(lu_logits),
                                     categorical_entropy(road_logits))
        return log_prob[..., None], entropy[..., None], value


@torch.no_grad()
def init_like_flax(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every Linear as flax.linen.Dense initializes it: the weight
    from lecun_normal (a normal truncated at two standard deviations,
    variance 1 / fan_in after truncation), the bias zero."""
    trunc_std = 0.87962566103423978   # std of a unit normal cut to [-2, 2]
    for m in model.modules():
        if isinstance(m, nn.Linear):
            std = (1.0 / m.in_features) ** 0.5 / trunc_std
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
    return model


def create_model(cfg, max_num_nodes: int | None = None,
                 max_num_edges: int | None = None) -> ActorCritic:
    """Build the SGNN actor-critic from a config's spec dicts. The graph
    caps default to the config's and are normally the env spec's
    (num_features, NE)."""
    se = cfg.state_encoder_specs
    return ActorCritic(
        hidden_size=tuple(se['state_encoder_hidden_size']),
        gcn_node_dim=se['gcn_node_dim'],
        num_gcn_layers=se.get('num_gcn_layers', 2),
        num_edge_fc_layers=se.get('num_edge_fc_layers', 1),
        num_attention_heads=se.get('num_attention_heads', 1),
        max_num_nodes=max_num_nodes or se['max_num_nodes'],
        max_num_edges=max_num_edges or se['max_num_edges'],
        land_use_hidden=tuple(cfg.policy_specs['policy_land_use_head_hidden_size']),
        road_hidden=tuple(cfg.policy_specs['policy_road_head_hidden_size']),
        value_hidden=tuple(cfg.value_specs['value_head_hidden_size']))
