"""Adam in plain PyTorch, as Kingma and Ba give it with the bias corrections
counted from 1 and ``eps`` outside the root."""

from __future__ import annotations

from typing import Dict

import torch


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               lr: float) -> None:
        """One update of ``params`` in place."""
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for k, p in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1.0 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1.0 - self.b2) * g * g
            p -= lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps)
