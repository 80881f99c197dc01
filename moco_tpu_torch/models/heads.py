"""The MoCo-v3 projection and prediction heads (port of
`moco_tpu/models/heads.py`).

Projector: 3 bias-free linears, hidden 4096, out 256, a BatchNorm after
every linear, ReLU after the hidden ones, and no affine on the last BN.
Predictor (the query side only): 2 bias-free linears, hidden 4096, BN and
ReLU between. Both run in f32 on [B, D] vectors. Module names follow flax:
`mlp.fc{i}`, `mlp.bn{i}`.

`BatchNorm1d` is flax `nn.BatchNorm` (momentum 0.9, epsilon 1e-5), not
`torch.nn.BatchNorm1d`: the batch variance is the BIASED mean-of-squares
form `max(0, E[x^2] - E[x]^2)`, and the running variance is updated with it
(torch's momentum 0.1 is flax's 0.9, and torch updates with the unbiased
variance). These BNs are plain PyTorch: the JAX heads run no kernel either.
"""

from __future__ import annotations

import torch
from torch import nn

from moco_tpu_torch.models.resnet import lecun_normal_


class BatchNorm1d(nn.Module):
    """flax `nn.BatchNorm` over the rows of a [B, C] f32 input: `weight`/
    `bias` are flax's `scale`/`bias` (absent with `affine=False`), the
    `running_mean`/`running_var` buffers its `mean`/`var`; `momentum` is the
    weight of the OLD running value."""

    def __init__(self, num_features: int, affine: bool = True, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.weight = self.bias = None
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean(dim=0)
            var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach() * (1 - m))
                self.running_var.mul_(m).add_(var.detach() * (1 - m))
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (x - mean) * mul
        if self.bias is not None:
            y = y + self.bias
        return y


class _MLP(nn.Module):
    def __init__(self, in_dim: int, num_layers: int, hidden_dim: int, out_dim: int,
                 last_bn: bool):
        super().__init__()
        self.num_layers, self.last_bn = num_layers, last_bn
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        for i in range(num_layers):
            last = i == num_layers - 1
            self.add_module(f"fc{i}", nn.Linear(dims[i], dims[i + 1], bias=False))
            if not last:
                self.add_module(f"bn{i}", BatchNorm1d(dims[i + 1]))
            elif last_bn:
                self.add_module(f"bn{i}", BatchNorm1d(dims[i + 1], affine=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
            if i < self.num_layers - 1:
                x = torch.relu(getattr(self, f"bn{i}")(x))
            elif self.last_bn:
                x = getattr(self, f"bn{i}")(x)
        return x


class _Head(nn.Module):
    def __init__(self, in_dim: int, num_layers: int, hidden_dim: int, out_dim: int,
                 last_bn: bool, generator: torch.Generator):
        super().__init__()
        self.mlp = _MLP(in_dim, num_layers, hidden_dim, out_dim, last_bn)
        for mod in self.mlp.modules():
            if isinstance(mod, nn.Linear):
                lecun_normal_(mod.weight, mod.in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)


class V3Projector(_Head):
    """3-layer projector, hidden 4096 -> out 256, BN throughout."""

    def __init__(self, in_dim: int, hidden_dim: int = 4096, out_dim: int = 256,
                 generator: torch.Generator | None = None):
        super().__init__(in_dim, 3, hidden_dim, out_dim, True,
                         generator or torch.Generator().manual_seed(0))


class V3Predictor(_Head):
    """2-layer predictor on the query side only."""

    def __init__(self, in_dim: int, hidden_dim: int = 4096, out_dim: int = 256,
                 generator: torch.Generator | None = None):
        super().__init__(in_dim, 2, hidden_dim, out_dim, False,
                         generator or torch.Generator().manual_seed(0))
