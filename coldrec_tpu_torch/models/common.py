"""Shared model building blocks (the port's counterpart of
``coldrec_tpu/models/common.py``): initializers, Linear layers and MLPs,
dropout, the weight-masked BatchNorm, and the carrier of weights from the
JAX package.

Layers are ``nn.Linear`` modules, whose weight is (out, in); the JAX
package keeps ``{"w": (in, out), "b": (out,)}``. Every module of the port
that holds weights lists them with their JAX path in ``jax_slots()``, and
:func:`load_jax` / :func:`jax_value` carry values across (transposing the
Linear weights) both ways. Initial draws come from a CPU
``torch.Generator``, so a seed gives the same weights on every device.
"""
from __future__ import annotations

import math
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

# (JAX path, tensor, transposed): the path starts with "params" or "state"
Slot = Tuple[tuple, torch.Tensor, bool]


def xavier_uniform(
    shape: Sequence[int],
    generator: torch.Generator,
    device="cpu",
    dtype=torch.float32,
) -> torch.Tensor:
    """Uniform(-a, a) with a = sqrt(6 / (fan_in + fan_out)) over the last two
    dims: ``nn.init.xavier_uniform_``'s gain-1 rule, which the reference uses
    for every embedding table (e.g. ColdRec MF.py:73-79) and which the JAX
    package's ``xavier_uniform`` copies. Draws come from ``generator`` on the
    CPU, so a seed gives the same table on every device."""
    fan_in, fan_out = shape[-2], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype)
    return (u * (2.0 * limit) - limit).to(device)


def xavier_normal(
    shape: Sequence[int],
    generator: torch.Generator,
    dtype=torch.float32,
) -> torch.Tensor:
    """N(0, std^2) with std = sqrt(2 / (fan_in + fan_out)) over the last two
    dims (``nn.init.xavier_normal_``'s gain-1 rule; CCFCRec's and M2VAE's
    ``_xavier_normal``), drawn on the CPU from ``generator``."""
    fan_in, fan_out = shape[-2], shape[-1]
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return torch.randn(tuple(shape), generator=generator, dtype=dtype) * std


def table_param(table) -> nn.Parameter:
    """A trainable copy of an embedding table (a tensor on any device, or a
    numpy array), in float32."""
    if isinstance(table, torch.Tensor):
        return nn.Parameter(table.detach().float().clone())
    return nn.Parameter(torch.from_numpy(np.array(table, dtype=np.float32)))


def linear_params(in_dim: int, out_dim: int, generator: torch.Generator,
                  bias: bool = True) -> nn.Linear:
    """torch's nn.Linear default init (kaiming-uniform weight, uniform
    bias, both within 1/sqrt(in_dim)), drawn from ``generator``."""
    layer = nn.utils.skip_init(nn.Linear, in_dim, out_dim, bias=bias)
    bound = 1.0 / math.sqrt(in_dim)
    with torch.no_grad():
        for p in layer.parameters():
            p.uniform_(-bound, bound, generator=generator)
    return layer


def linear_params_tn(in_dim: int, out_dim: int, generator: torch.Generator,
                     std: float = 0.01) -> nn.Linear:
    """Linear with a truncated-normal weight (std ``std``, cut at +-2 std)
    and zero bias (DropoutNet.py:138-152, ALDI.py:191-208)."""
    layer = nn.utils.skip_init(nn.Linear, in_dim, out_dim)
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        layer.bias.zero_()
    return layer


def linear_slots(layer: nn.Linear, path: tuple) -> list:
    """The slots of one Linear at JAX path ``path`` ({"w", "b"})."""
    slots = [(path + ("w",), layer.weight, True)]
    if layer.bias is not None:
        slots.append((path + ("b",), layer.bias, False))
    return slots


def mlp_params(dims: Sequence[int], generator: torch.Generator
               ) -> nn.ModuleList:
    return nn.ModuleList(linear_params(a, b, generator)
                         for a, b in zip(dims[:-1], dims[1:]))


def mlp_apply(layers: nn.ModuleList, x: torch.Tensor,
              activation: Callable = torch.relu,
              final_activation: Optional[Callable] = None) -> torch.Tensor:
    """The reference MLP (utils.py:10-22) for any depth: ``activation``
    between the layers, ``final_activation`` after the last."""
    for i, layer in enumerate(layers):
        x = layer(x)
        if i < len(layers) - 1:
            x = activation(x)
        elif final_activation is not None:
            x = final_activation(x)
    return x


def mlp_slots(layers: nn.ModuleList, path: tuple) -> list:
    return [s for i, layer in enumerate(layers)
            for s in linear_slots(layer, path + (i,))]


def rows_of(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along dim 0 by ``index_select``, whose backward is an
    ``index_add_`` (atomics on the card). The backward of ``x[idx]``
    (``index_put_`` with accumulate) sorts the indices and walks each row's
    duplicates in turn: FSGNN's GAT, gathering the rows of 876,642 edges
    onto zipf-popular items at book-crossing shape, took 119 ms forward and
    backward that way on an H100 and 12 ms this way (PERF.md)."""
    return x.index_select(0, idx)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout: keep each entry with probability 1 - rate and
    scale it by 1 / (1 - rate); the identity outside training."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class MaskedBatchNorm1d(nn.Module):
    """torch BatchNorm1d semantics, with batch statistics weighted by the
    batch's real / pad ``weight`` (1.0 / 0.0), so a padded batch normalises
    as the reference's unpadded one: mean and (biased) variance over the
    real rows, the running variance updated with the unbiased estimate at
    n = sum(weight). ``nn.BatchNorm1d`` takes no weight vector. Running
    statistics are buffers, updated in training mode on every call."""

    def __init__(self, dim: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor,
                weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.training:
            if weight is not None:
                w = weight[:, None]
                n = weight.sum().clamp_min(1.0)
                mean = (x * w).sum(dim=0) / n
                var = ((x - mean) ** 2 * w).sum(dim=0) / n
                unbiased = var * n / (n - 1.0).clamp_min(1.0)
            else:
                n = x.shape[0]
                mean = x.mean(dim=0)
                var = x.var(dim=0, unbiased=False)
                unbiased = var * n / max(n - 1, 1)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(
                    (1 - m) * self.running_mean + m * mean.detach())
                self.running_var.copy_(
                    (1 - m) * self.running_var + m * unbiased.detach())
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) / torch.sqrt(var + self.eps) * self.scale + self.bias

    def slots(self, path: tuple, state_path: tuple) -> list:
        return [(path + ("scale",), self.scale, False),
                (path + ("bias",), self.bias, False),
                (state_path + ("mean",), self.running_mean, False),
                (state_path + ("var",), self.running_var, False)]


def _get(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def jax_value(tree: dict, path: tuple) -> np.ndarray:
    """The leaf at ``path`` of {"params": ..., "state": ...} as numpy."""
    return np.asarray(_get(tree, path), dtype=np.float32)


def load_jax(slots: Iterator[Slot], params: dict,
             state: Optional[dict] = None) -> None:
    """Copy the JAX package's ``params`` / ``net_state`` (numpy leaves)
    into the slots, transposing Linear weights; shapes must match. With no
    ``state`` the state slots keep their values."""
    tree = {"params": params, "state": state}
    with torch.no_grad():
        for path, tensor, transposed in slots:
            if tree[path[0]] is None:
                continue
            value = jax_value(tree, path)
            if transposed:
                value = value.T
            if tuple(value.shape) != tuple(tensor.shape):
                raise ValueError(f"{'/'.join(map(str, path))}: JAX shape "
                                 f"{value.shape} != {tuple(tensor.shape)}")
            tensor.copy_(torch.from_numpy(np.array(value)))


class JaxCarried:
    """Mixin of a module whose weights the JAX package also holds: it lists
    them in ``jax_slots()`` and names its constructor's arguments for a
    JAX ``params`` tree in ``jax_shapes(params)``."""

    def jax_slots(self) -> list:
        raise NotImplementedError

    @staticmethod
    def jax_shapes(params: dict) -> dict:
        raise NotImplementedError

    def load_jax(self, params: dict, state: Optional[dict] = None) -> None:
        load_jax(self.jax_slots(), params, state)

    @classmethod
    def from_jax_params(cls, params: dict, state: Optional[dict] = None,
                        device="cuda"):
        """The module holding exactly the JAX trainer's ``params`` and
        ``net_state`` (numpy leaves, e.g. ``jax.tree_util.tree_map(
        np.asarray, trainer.params)``)."""
        module = cls(**cls.jax_shapes(params), device=device)
        module.load_jax(params, state)
        return module
