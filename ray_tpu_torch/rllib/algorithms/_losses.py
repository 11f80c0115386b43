"""Pieces the port's policy losses share."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def action_logp(logits: torch.Tensor, actions: torch.Tensor):
    """(log_softmax over the actions, the taken actions' log-probs)."""
    logp_all = F.log_softmax(logits, dim=-1)
    return logp_all, torch.gather(logp_all, -1,
                                  actions.long()[:, None])[:, 0]


def entropy(logits: torch.Tensor, logp_all: torch.Tensor) -> torch.Tensor:
    """Mean categorical entropy, ``-(softmax * log_softmax).sum(-1)``."""
    return -(F.softmax(logits, dim=-1) * logp_all).sum(-1).mean()
