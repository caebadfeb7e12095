"""Switch-style mixture-of-experts MLP (``unext_moe``). Counterpart of
``unet_zoo_tpu/nn/moe.py``.

Tokens are the leading dims of a ``[..., D]`` input flattened in order
(``[B, H, W]`` for the channels-last tokens of a MiT block), cut into groups
of ``min(group_size, T)`` tokens (a group may span images; the last one is
padded with zero tokens). Each token goes to its top-1 expert by a float32
softmax router (ties to the lowest index); an expert takes at most
``ceil(capacity_factor * G / E)`` tokens of a group, in token order, and the
rest are dropped: their output is zero and the block's residual carries
them. A kept token's output is its expert's FFN (fc1, exact GELU, fc2, in
the compute type) times its gate, the top probability cast to the compute
type, as JAX casts the combine tensor.

JAX dispatches through dense one-hot einsums; here the same slots are filled
and read by an index gather (ATen): each expert's capacity slots of a group
form a ``[Z, E, C, D]`` batch, the expert FFNs run as one batched matmul over
it, and each kept token reads its slot back. Empty slots hold zero tokens,
as in JAX, and no token reads them.

In training the Switch load-balancing loss ``aux_loss_weight * E *
mean_z(sum_e f_e P_e)`` (f_e the share of a group's tokens routed to e, P_e
its mean router probability) is left in ``aux_loss``, where the train step
collects it (:func:`pop_aux_losses`); in eval it is ``None``.

In a data-parallel step (``parallel.global_batch.data_group``) the groups
are those of the global batch, whose tokens follow rank by rank: a rank's
tokens must be whole groups, so that each rank routes its groups as one
process would and the loss, a mean over groups, is the mean of the ranks'
terms; a group that would span two ranks raises.

The capacity factor (1.25), group size (256) and loss weight (0.01) are
JAX's defaults, the only values its registry uses: class constants here,
which a test may override on an instance.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from unet_zoo_tpu_torch.parallel.global_batch import data_group, group_size


class SwitchMoEMLP(nn.Module):
    """Top-1-routed mixture-of-experts FFN over the trailing feature dim.

    Parameters keep JAX's names and shapes: ``router_kernel [D, E]``,
    ``expert_fc1_kernel [E, D, H]``, ``expert_fc1_bias [E, H]``,
    ``expert_fc2_kernel [E, H, D]``, ``expert_fc2_bias [E, D]``, float32,
    cast to ``dtype`` at use (the router stays float32).
    """

    capacity_factor = 1.25
    group_size = 256
    aux_loss_weight = 0.01

    def __init__(self, dim: int, num_experts: int, hidden_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        e = num_experts
        self.num_experts, self.dtype = num_experts, dtype
        self.router_kernel = nn.Parameter(torch.zeros(dim, e))
        self.expert_fc1_kernel = nn.Parameter(torch.zeros(e, dim, hidden_dim))
        self.expert_fc1_bias = nn.Parameter(torch.zeros(e, hidden_dim))
        self.expert_fc2_kernel = nn.Parameter(torch.zeros(e, hidden_dim, dim))
        self.expert_fc2_bias = nn.Parameter(torch.zeros(e, dim))
        self.aux_loss: Optional[torch.Tensor] = None
        # the last forward's routing, for readings: [Z, G] choices, kept flags, real tokens
        self.last_routing: Optional[dict] = None

    @torch.no_grad()
    def draw_parameters(self, generator: torch.Generator) -> None:
        """``init_weights``' draw: the router at LeCun scale (std sqrt(1 / D),
        JAX's ``lecun_normal``), the expert kernels at the port's Linear scale
        (std sqrt(0.25 / fan_in)), zero biases."""
        d, _ = self.router_kernel.shape
        hid = self.expert_fc1_kernel.shape[-1]
        self.router_kernel.normal_(0.0, (1.0 / d) ** 0.5, generator=generator)
        self.expert_fc1_kernel.normal_(0.0, (0.25 / d) ** 0.5, generator=generator)
        self.expert_fc2_kernel.normal_(0.0, (0.25 / hid) ** 0.5, generator=generator)
        self.expert_fc1_bias.zero_()
        self.expert_fc2_bias.zero_()

    def capacity(self, g: int) -> int:
        return max(1, math.ceil(self.capacity_factor * g / self.num_experts))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        e, dt = self.num_experts, self.dtype
        lead = x.shape[:-1]
        tokens = x.reshape(-1, d)
        t = tokens.shape[0]
        g = min(self.group_size, t)
        group = data_group()
        if group is not None:
            # the global batch's grouping: this rank's tokens must be whole groups of it
            g = min(self.group_size, t * group_size(group))
            if t % g:
                raise ValueError(
                    f"a Switch-MoE input of shape {tuple(x.shape)} a rank ({t} tokens) over "
                    f"{group_size(group)} ranks: its {g}-token routing groups would span two "
                    "ranks' rows; use a per-rank batch whose tokens are whole groups")
        pad = (-t) % g
        if pad:
            tokens = torch.cat([tokens, tokens.new_zeros(pad, d)])
        xs = tokens.reshape(-1, g, d)                               # [Z, G, D]
        z = xs.shape[0]
        cap = self.capacity(g)

        # routing in float32; argmax takes the first of equal probabilities
        probs = torch.softmax(xs.float() @ self.router_kernel.float(), dim=-1)   # [Z, G, E]
        choice = torch.argmax(probs, dim=-1)                        # [Z, G]
        gate = probs.gather(-1, choice[..., None])[..., 0]          # [Z, G]
        onehot = F.one_hot(choice, e).float()
        pos = (torch.cumsum(onehot, dim=1) * onehot).sum(-1).long()  # 1-based place in its queue
        kept = pos <= cap

        if self.training and self.aux_loss_weight:
            f_e, p_e = onehot.mean(dim=1), probs.mean(dim=1)        # [Z, E]
            aux = e * torch.mean(torch.sum(f_e * p_e, dim=-1))
            self.aux_loss = self.aux_loss_weight * aux
        else:
            self.aux_loss = None
        self.last_routing = dict(choice=choice.detach(), kept=kept.detach(), tokens=t)

        # each kept token's slot in the flat [Z * E * C] slot table; a dropped
        # token points one past its end, at a row that stays zero
        zi = torch.arange(z, device=x.device)[:, None]
        slot = torch.where(kept, (zi * e + choice) * cap + pos - 1, z * e * cap)   # [Z, G]
        src = torch.full((z * e * cap + 1,), z * g, dtype=torch.long, device=x.device)
        src.scatter_(0, slot.reshape(-1), torch.arange(z * g, device=x.device))
        padded = torch.cat([xs.reshape(-1, d).to(dt), xs.new_zeros(1, d, dtype=dt)])
        expert_in = padded[src[:-1]].reshape(z, e, cap, d)          # [Z, E, C, D]

        # the expert FFNs: one batched matmul each way, biases added after it
        w1, b1 = self.expert_fc1_kernel.to(dt), self.expert_fc1_bias.to(dt)
        w2, b2 = self.expert_fc2_kernel.to(dt), self.expert_fc2_bias.to(dt)
        h = torch.einsum("zecd,edh->zech", expert_in, w1) + b1[None, :, None, :]
        h = F.gelu(h)
        out = torch.einsum("zech,ehd->zecd", h, w2) + b2[None, :, None, :]

        # combine: each kept token's slot times its gate in the compute type
        out = torch.cat([out.reshape(-1, d), out.new_zeros(1, d)])
        weight = torch.where(kept, gate, torch.zeros_like(gate)).to(dt)
        y = out[slot.reshape(-1)] * weight.reshape(-1, 1)
        return y[:t].reshape(*lead, d)


def aux_loss_modules(module: nn.Module) -> List[nn.Module]:
    """The submodules of ``module`` that leave an auxiliary loss
    (``aux_loss``) in a training forward."""
    return [m for m in module.modules() if hasattr(m, "aux_loss")]


def pop_aux_losses(modules: Iterable[nn.Module]) -> List[torch.Tensor]:
    """Every auxiliary loss that ``modules`` (e.g. :func:`aux_loss_modules`)
    left in their last training forward, each cleared once read."""
    found = []
    for m in modules:
        aux = getattr(m, "aux_loss", None)
        if aux is not None:
            found.append(aux)
            m.aux_loss = None
    return found
