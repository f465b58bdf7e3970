"""The reference trainers' optimizer: optax's global-norm clip, then AdamW."""
from __future__ import annotations

import torch


class ClippedAdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(lr,
    weight_decay))`` on a model's ``.grad``s.

    The clip is optax's: when the global norm ``g`` of all gradients
    reaches ``max_norm``, each gradient becomes ``grad / g * max_norm``
    (``torch.nn.utils.clip_grad_norm_`` would add 1e-6 to ``g``). AdamW
    takes optax's defaults: betas (0.9, 0.999), eps 1e-8, decoupled weight
    decay ``weight_decay`` (torch's own default is 1e-2). The clip decides
    on the device: no host sync.
    """

    def __init__(self, params, lr: float, weight_decay: float,
                 max_norm: float):
        self.params = list(params)
        self.max_norm = float(max_norm)
        self.adamw = torch.optim.AdamW(self.params, lr=lr,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)

    @property
    def param_groups(self):
        return self.adamw.param_groups

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self):
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < self.max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / g_norm * self.max_norm))
        self.adamw.step()
