"""Shared NN building blocks (port of declip_tpu/models/layers.py).

The reference's transformer core
(prototype/model/image_encoder/base_transformer.py): pre-LN residual blocks
with a fused qkv projection, LayerNorm with fp32 statistics, QuickGELU MLP.
The depth stack is an ``nn.ModuleList`` named ``resblocks``, so parameter
names are the reference's torch state-dict names.

Precision follows the JAX package's flax ``dtype`` (not autocast): parameters
stay fp32, every dense layer casts its input, weight and bias to the
compute ``dtype`` at use, and LayerNorm takes fp32 statistics and returns the
compute dtype, so the residual stream itself is in the compute dtype
(layers.py:34-45, vit.py:75).

Parameters are created uninitialised on ``device``; ``init_weights``
fills them from an explicit ``torch.Generator`` with the JAX package's
init scheme (layers.py:258-260).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from declip_tpu_torch.ops import quant
from declip_tpu_torch.ops.attention import (
    dot_product_attention,
    merge_heads,
    split_heads,
)
from declip_tpu_torch.ops.contrastive import gather_features
from declip_tpu_torch.parallel import comms
from declip_tpu_torch.parallel.dist import Group

# the JAX package's remat policies (layers.py:300-308): how XLA trades saved
# activations against recompute when ``checkpoint`` is off. PyTorch saves
# what autograd needs and recomputes nothing, so each value computes the
# same result here; ``checkpoint: True`` (full remat) is the one that acts.
REMAT_POLICIES = ("policy", "dots", "all")


def as_dtype(dtype: Union[str, torch.dtype, None]) -> torch.dtype:
    """A compute dtype from a config value (``"bfloat16"``,
    ``"torch.float32"``, a ``torch.dtype``); None is float32."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        out = getattr(torch, str(dtype).replace("torch.", ""), None)
    if not isinstance(out, torch.dtype) or not out.is_floating_point:
        raise ValueError(f"model dtype {dtype!r} is not a floating dtype")
    return out


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) — reference QuickGELU (base_transformer.py:24-26)."""
    return x * torch.sigmoid(1.702 * x)


def uninitialised(module_cls, *args, device=None):
    """``module_cls(*args)`` with its parameters left uninitialised
    (``init_weights`` fills them from a generator)."""
    return nn.utils.skip_init(module_cls, *args, device=device or "cpu")


def linear(d_in: int, d_out: int, device=None) -> nn.Linear:
    return uninitialised(nn.Linear, d_in, d_out, device=device)


def init_linear(layer: nn.Linear, std: float, generator: torch.Generator):
    nn.init.normal_(layer.weight, std=std, generator=generator)
    nn.init.zeros_(layer.bias)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator):
    """flax's default Dense and Conv kernel init: truncated (+-2 sigma)
    normal of variance 1/fan_in, fan_in the size of one output's slice."""
    std = (1.0 / weight[0].numel()) ** 0.5 / .87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: input, weight and bias cast to the
    compute dtype, the product in that dtype (fp32 accumulation). Inside
    ``ops.quant.int8_inference`` the product runs in int8 where both
    widths reach its ``min_dim``, as every Dense of the JAX package does
    under its interceptor."""
    if quant.routes(x, weight.shape[0]):
        return quant.int8_dense(x, weight, bias, dtype)
    return F.linear(x.to(dtype), weight.to(dtype),
                    None if bias is None else bias.to(dtype))


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics and fp32 parameters whatever the input
    dtype, eps 1e-5; the output is in the compute ``dtype``."""

    def __init__(self, width: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(width, eps=eps, device=device, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.compute_dtype)


BN_MOMENTUM = 0.1  # flax's 0.9 as torch counts it
BN_EPS = 1e-5


@dataclass(frozen=True)
class BnAxis:
    """BatchNorm across ranks: ``norm``, the group of ranks whose joint
    moments normalise this rank's batch (None: this rank's batch alone);
    ``stats``, the group whose moments the running statistics take, the
    data group, so that every rank holds the same running statistics."""

    norm: Optional[Group]
    stats: Group


class BatchNorm(nn.Module):
    """BatchNorm over axis 1 of [N, C] or [N, C, H, W] with flax's
    semantics, which differ from ``torch.nn.BatchNorm2d``:

    - statistics are fp32 whatever the compute dtype, eps 1e-5, flax
      momentum 0.9 (torch momentum 0.1);
    - the running variance is updated with the *biased* batch variance,
      the one the batch is normalised with (torch uses the unbiased one);
    - a training forward does not write the running statistics. It leaves
      them pending on the module, chained call to call as flax's mutable
      collection chains them, and the train step commits them after a
      finite step, or drops them (:func:`commit_bn_stats`,
      :func:`discard_bn_stats`), so that a skipped step leaves them as they
      were, as the JAX step's ``_keep_if_finite`` does.

    ``weight``/``bias`` and the ``running_mean``/``running_var`` buffers
    carry the reference's torch names. ``stats_groups > 1`` normalises each
    of that many contiguous batch groups with its own moments and updates
    the running statistics with the global ones (the JAX package's ``_GroupedScaleBias``).

    ``axis_name`` (a :class:`BnAxis`): the same across ranks, each rank
    holding its own rows of the global batch. The batch is normalised with
    the moments of its rank group, each rank's fp32 mean and squared
    deviations gathered over the group (differentiably) and combined into
    the group's variance, not a mean of per-rank variances; the running
    statistics take the moments of the whole data group, as
    ``stats_groups`` takes the global ones. A rank group of one rank
    (``use_sync_bn: false``, or a world of one) normalises with cuDNN's
    batch norm as one process does. Eval mode needs no collective."""

    def __init__(self, num_features: int, zero_scale: bool = False,
                 stats_groups: int = 1, device=None,
                 axis_name: Optional[BnAxis] = None):
        super().__init__()
        self.zero_scale = zero_scale
        self.stats_groups = stats_groups
        self.axis_name = axis_name
        self.weight = nn.Parameter(torch.empty(num_features, device=device))
        self.bias = nn.Parameter(torch.empty(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))
        self.pending: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def init_weights(self) -> None:
        nn.init.constant_(self.weight, 0.0 if self.zero_scale else 1.0)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)
        self.pending = None

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        """Batch statistics in training mode, the running ones in eval mode
        or where ``use_running_average`` says so. The output has x's
        dtype."""
        if use_running_average is None:
            use_running_average = not self.training
        if use_running_average:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, BN_EPS)
        base_mean, base_var = self.pending or (self.running_mean,
                                               self.running_var)
        axis = self.axis_name
        if axis is not None:
            if self.stats_groups > 1:
                raise ValueError("BatchNorm takes stats_groups or an "
                                 "axis_name, not both")
            if axis.norm is not None and axis.norm.size > 1:
                return self._synced(x, base_mean, base_var)
            if axis.stats.size > 1:
                # this rank's moments normalise it (cuDNN's batch norm);
                # the running statistics take the data group's
                y = F.batch_norm(x, None, None, self.weight, self.bias,
                                 True, 0.0, BN_EPS)
                with torch.no_grad():
                    local, n = _moments(x)
                    self.pending = _moved(base_mean, base_var, *_combine(
                        local, n, axis.stats, differentiable=False))
                return y
        if self.stats_groups > 1:
            return self._grouped(x, base_mean, base_var)
        mean, var = base_mean.clone(), base_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                         BN_MOMENTUM, BN_EPS)
        with torch.no_grad():
            # F.batch_norm moved var by the unbiased variance n/(n-1) v:
            # take the excess back out, leaving the biased v that flax uses
            # (out of place: autograd saved the tensor F.batch_norm moved)
            n = x.numel() // x.shape[1]
            var = var - (var - (1 - BN_MOMENTUM) * base_var) / n
        self.pending = (mean, var)
        return y

    def _grouped(self, x, base_mean, base_var):
        g = self.stats_groups
        n = x.shape[0]
        if n % g:
            raise ValueError(
                f"BatchNorm stats_groups={g} must divide the batch axis "
                f"({n}); check batch_size x data-parallel ways vs "
                f"use_sync_bn/bn_group_size")
        xs = x.float().reshape(g, n // g, *x.shape[1:])
        axes = (1,) + tuple(range(3, xs.ndim))
        mean = xs.mean(dim=axes, keepdim=True)               # [G,1,C,1..]
        sq = (xs * xs).mean(dim=axes, keepdim=True)
        var = torch.clamp(sq - mean * mean, min=0.0)
        shape = (1, 1, -1) + (1,) * (xs.ndim - 3)
        y = (xs - mean) * torch.rsqrt(var + BN_EPS)
        y = y * self.weight.view(shape) + self.bias.view(shape)
        with torch.no_grad():
            gmean = mean.mean(dim=0).reshape(-1)
            gvar = torch.clamp(sq.mean(dim=0).reshape(-1) - gmean * gmean,
                               min=0.0)
            self.pending = (
                (1 - BN_MOMENTUM) * base_mean + BN_MOMENTUM * gmean,
                (1 - BN_MOMENTUM) * base_var + BN_MOMENTUM * gvar)
        return y.reshape(x.shape).to(x.dtype)

    def _synced(self, x, base_mean, base_var):
        """Each rank's fp32 mean and sum of squared deviations, gathered
        over the group and combined as Chan et al. combine them (each
        rank holds as many rows): accurate where the mean is large against
        the deviation, which the mean of squares less the squared mean is
        not."""
        axis = self.axis_name
        local, n = _moments(x)
        mean, var = _combine(local, n, axis.norm, differentiable=True)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        y = (x.float() - mean.view(shape)) * torch.rsqrt(
            var + BN_EPS).view(shape)
        y = y * self.weight.view(shape) + self.bias.view(shape)
        with torch.no_grad():
            if axis.norm == axis.stats:
                stats = (mean.detach(), var.detach())
            else:
                stats = _combine(local.detach(), n, axis.stats,
                                 differentiable=False)
            self.pending = _moved(base_mean, base_var, *stats)
        return y.to(x.dtype)

    def commit(self) -> None:
        if self.pending is not None:
            self.running_mean.copy_(self.pending[0])
            self.running_var.copy_(self.pending[1])
            self.pending = None


def _moments(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """This rank's fp32 [mean, sum of squared deviations] [2, C] of x over
    every axis but 1, and the count of its rows."""
    xf = x.float()
    dims = (0,) + tuple(range(2, x.ndim))
    mean = xf.mean(dim=dims)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    m2 = ((xf - mean.view(shape)) ** 2).sum(dim=dims)
    return torch.stack([mean, m2]), x.numel() // x.shape[1]


def _moved(base_mean, base_var, mean, var):
    """The running statistics moved by a batch's (mean, biased var)."""
    return ((1 - BN_MOMENTUM) * base_mean + BN_MOMENTUM * mean,
            (1 - BN_MOMENTUM) * base_var + BN_MOMENTUM * var)


def _combine(local: torch.Tensor, n: int, group, differentiable: bool):
    """The (mean, biased variance) [C] of a group's rows from each rank's
    [mean, sum of squared deviations] [2, C] over ``n`` rows (None: this
    rank's alone)."""
    if group is None:
        return local[0], local[1] / n
    if differentiable:
        parts = gather_features(local, group)
    else:
        parts = comms.all_gather(local, group)
    means, m2s = parts.view(group.size, 2, -1).unbind(1)
    mean = means.mean(dim=0)
    m2 = m2s.sum(dim=0) + n * ((means - mean) ** 2).sum(dim=0)
    return mean, m2 / (n * group.size)


def commit_bn_stats(model: nn.Module) -> None:
    """Write every BatchNorm's pending running statistics into its
    buffers (after a finite training step)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.commit()


def discard_bn_stats(model: nn.Module) -> None:
    """Drop every BatchNorm's pending running statistics (a skipped step,
    or a forward that no step commits)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.pending = None


class MultiHeadAttention(nn.Module):
    """Self-attention with the fused qkv projection.

    Parameters: ``in_proj_weight`` [3D, D] and ``in_proj_bias`` [3D] (rows
    q, k, v), ``out_proj`` Linear(D, D) — torch ``nn.MultiheadAttention``'s
    names, which the reference checkpoints carry."""

    def __init__(self, width: int, num_heads: int, attn_impl: str = "auto",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(
            torch.empty(3 * width, width, device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width, device=device))
        self.out_proj = linear(width, width, device)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        qkv = dense(x, self.in_proj_weight, self.in_proj_bias, self.dtype)
        q, k, v = (split_heads(t, self.num_heads)
                   for t in qkv.chunk(3, dim=-1))
        o = dot_product_attention(q, k, v, causal=causal, impl=self.attn_impl)
        return dense(merge_heads(o), self.out_proj.weight, self.out_proj.bias,
                     self.dtype)


class MlpBlock(nn.Module):
    """c_fc -> QuickGELU -> c_proj (4x expansion), reference mlp block."""

    def __init__(self, width: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.c_fc = linear(width, 4 * width, device)
        self.c_proj = linear(4 * width, width, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = quick_gelu(dense(x, self.c_fc.weight, self.c_fc.bias, self.dtype))
        return dense(h, self.c_proj.weight, self.c_proj.bias, self.dtype)


def fp32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in fp32 at full precision (``Precision.HIGHEST``): on
    CUDA with TF32 switched off for the call."""
    a, b = a.float(), b.float()
    if not (a.is_cuda and torch.backends.cuda.matmul.allow_tf32):
        return a @ b
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True


class MoeMlpBlock(nn.Module):
    """Mixture-of-Experts replacement for :class:`MlpBlock` (the JAX
    package's ``MoeMlpBlock``, layers.py:130-227): token-choice top-k
    routing with a static per-expert capacity.

    Per token: router logits in fp32 at full precision, softmax, then k
    passes in the JAX package's order, each placing every token's next
    choice: a token's slot in its expert's buffer is the count of earlier
    tokens that chose that expert in this pass plus the slots earlier
    passes took (``cumsum(onehot) - onehot + taken``), and a token whose
    slot reaches ``cap = min(n, max(1, ceil(k n cf / E)))`` is dropped
    from that expert (the residual still carries it). The kept gates are
    renormalised per token. Each expert is ``quick_gelu`` FFN with
    biases. The Switch aux loss is ``E * sum_e f_e P_e``, f from the first
    choices, P the mean router probability.

    Dispatch and combine are index operations, not the JAX package's
    [n, E, C] one-hot einsums (the same numbers: a slot holds one token,
    a token at most k slots): the kept tokens' rows are copied into an
    [E, C, d] buffer, the experts run as two batched products, and each
    token gathers its k slots back, weighted by its gates.

    Global routing (``group``, the data group, in training): the JAX
    solver routes one GSPMD program over the global batch, so ``n``,
    ``cap``, the slot counts and the aux loss's means are the global
    batch's, its tokens in rank order. Each rank holds its own rows:
    one all-gather of the [k, E] per-pass counts gives each pass's
    offset of this rank's tokens (an exclusive prefix sum over the
    ranks) and the slots every pass takes; ``P_e`` is summed over the
    ranks by a gather whose backward sums the gradient, ``f_e`` from the
    gathered counts. A rank's buffer holds its own kept tokens only,
    ``min(cap, n_local)`` slots an expert (a token takes an expert at
    most once).

    Expert parallelism (``expert_group``, ``parallelism: {ep: N}``,
    parallel/mesh.py): this rank holds only its expert group's share of
    ``wi``/``bi``/``wo``/``bo`` (E/ep experts, ``parallel.fsdp``'s
    expert shards); in training the buffer's chunks travel to their
    experts' owners and back by a differentiable all-to-all. Eval mode
    routes over the batch it is given, with every expert local.

    ``forward(x)`` -> (y, aux), aux None outside training; ``kept`` is
    then the [k] count of the choices each pass kept over the routed
    batch (of its k * n: the rest were dropped)."""

    def __init__(self, width: int, num_experts: int, top_k: int = 2,
                 capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        e, h = num_experts, 4 * width
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.group = None  # the routing group (models.clip_model)
        self.expert_group = None  # EP (parallel.mesh.bind_experts)
        self.kept: Optional[torch.Tensor] = None
        self.router = nn.Parameter(torch.empty(width, e, device=device))
        self.wi = nn.Parameter(torch.empty(e, width, h, device=device))
        self.bi = nn.Parameter(torch.empty(e, h, device=device))
        self.wo = nn.Parameter(torch.empty(e, h, width, device=device))
        self.bo = nn.Parameter(torch.empty(e, width, device=device))

    def init_weights(self, generator: torch.Generator, fc_std: float,
                     proj_std: float) -> None:
        width = self.router.shape[0]
        nn.init.normal_(self.router, std=width ** -0.5, generator=generator)
        nn.init.normal_(self.wi, std=fc_std, generator=generator)
        nn.init.zeros_(self.bi)
        nn.init.normal_(self.wo, std=proj_std, generator=generator)
        nn.init.zeros_(self.bo)

    def forward(self, x: torch.Tensor):
        b, t, d = x.shape
        e = self.num_experts
        k = min(self.top_k, e)
        group = self.group if self.training else None
        world = 1 if group is None else group.size
        n_loc = b * t
        n = n_loc * world
        cap = min(n, max(1, math.ceil(k * n * self.capacity_factor / e)))
        slots = min(cap, n_loc)  # this rank's buffer, an expert
        xf = x.reshape(n_loc, d)
        probs = torch.softmax(fp32_matmul(xf, self.router), dim=-1)

        # the k choices (JAX's argmax: the first maximum)
        idx, gates, ranks, counts = [], [], [], []
        remaining = probs
        for j in range(k):
            i = torch.argmax(remaining, dim=-1)
            idx.append(i)
            gates.append(probs.gather(1, i[:, None])[:, 0])
            # a token's place among this pass's local tokens of its
            # expert, scanned along the tokens of an [E, n] one-hot (a
            # scan along dim 0 of [n, E] runs slowly on the card)
            onehot = F.one_hot(i, e).t().contiguous()
            ranks.append((torch.cumsum(onehot, 1) - onehot).gather(
                0, i[None])[0])
            counts.append(onehot.sum(1))
            if j + 1 < k:
                remaining = remaining.scatter(1, i[:, None], 0.0)
        counts = torch.stack(counts)  # [k, E]
        if group is not None:
            every = comms.all_gather(counts[None], group)  # [W, k, E]
            before = every[:group.rank].sum(0)
            total = every.sum(0)
        else:
            before, total = torch.zeros_like(counts), counts

        taken = torch.zeros(e, dtype=counts.dtype, device=x.device)
        base = torch.zeros_like(taken)
        keeps, dests, kept = [], [], []
        trash = e * slots
        for j in range(k):
            i = idx[j]
            keep = (taken + before[j])[i] + ranks[j] < cap
            keeps.append(keep)
            dests.append(torch.where(keep, i * slots + base[i] + ranks[j],
                                     trash))
            base = base + torch.clamp(cap - taken - before[j], min=0
                                      ).minimum(counts[j])
            kept.append(torch.clamp(cap - taken, min=0).minimum(total[j]))
            taken = taken + kept[-1]
        # the global batch's kept choices by pass (drop statistics)
        self.kept = torch.stack(kept).sum(1)
        gate_sum = sum(g * kp for g, kp in zip(gates, keeps))
        norm = torch.clamp(gate_sum, min=1e-9)
        weights = [g * kp / norm for g, kp in zip(gates, keeps)]

        # dispatch: each kept choice's row copied into its slot (an empty
        # slot stays a zero row; a dropped one goes to the trash row),
        # whose backward is a gather: no accumulation into shared rows
        buf = xf.new_zeros(trash + 1, d).index_copy(
            0, torch.cat(dests), xf.repeat(k, 1))
        out = self._experts(buf[:trash].view(e, slots, d))
        # combine: each token's kept slots, its gates cast to the compute
        # dtype as JAX casts the combine tensor
        out = torch.cat([out.reshape(trash, d), out.new_zeros(1, d)])
        y = sum(w.to(self.dtype).float()[:, None]
                * out.index_select(0, dst).float()
                for w, dst in zip(weights, dests))
        y = y.to(self.dtype).view(b, t, d)

        aux = None
        if self.training:
            frac = total[0].float() / n
            mean_p = probs.sum(0, keepdim=True)
            if group is not None:
                mean_p = gather_features(mean_p, group).sum(0)
            aux = e * torch.sum(frac * mean_p.reshape(e) / n)
        return y, aux

    def _experts(self, xin: torch.Tensor) -> torch.Tensor:
        """The expert FFNs on the [E, C, d] buffer; where this rank holds
        only its share of the experts (expert parallelism in training),
        on the owners of the experts."""
        if self.wi.shape[0] == self.num_experts:
            return self._ffn(xin)
        e, c, d = xin.shape
        group = self.expert_group
        ep, own = group.size, e // group.size
        # chunk r (experts r*own .. r*own+own-1) to rank r of the group
        recv = comms.AllToAll.apply(xin.reshape(e * c, d), group)
        recv = recv.view(ep, own, c, d).transpose(0, 1).reshape(
            own, ep * c, d)
        out = self._ffn(recv)
        out = out.view(own, ep, c, d).transpose(0, 1).reshape(e * c, d)
        return comms.AllToAll.apply(out, group).view(e, c, d)

    def _ffn(self, xin: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        hid = torch.bmm(xin.to(dt), self.wi.to(dt)) + self.bi[:, None].to(dt)
        return torch.bmm(quick_gelu(hid), self.wo.to(dt)) + \
            self.bo[:, None].to(dt)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block (base_transformer.py:29-53): the dense
    MLP, or with ``moe_experts`` a :class:`MoeMlpBlock` named ``moe``
    (layers.py:246-249, 270-276 of the JAX package). Its forward returns
    (x, the MoE aux loss or None)."""

    def __init__(self, width: int, num_heads: int, total_layers: int,
                 causal: bool = False, attn_impl: str = "auto",
                 dtype: torch.dtype = torch.float32, device=None,
                 moe_experts: int = 0, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25):
        super().__init__()
        self.total_layers = total_layers
        self.causal = causal
        self.ln_1 = LayerNorm(width, dtype=dtype, device=device)
        self.attn = MultiHeadAttention(width, num_heads, attn_impl, dtype,
                                       device)
        self.ln_2 = LayerNorm(width, dtype=dtype, device=device)
        if moe_experts:
            self.moe = MoeMlpBlock(width, moe_experts, moe_top_k,
                                   moe_capacity_factor, dtype, device)
        else:
            self.mlp = MlpBlock(width, dtype, device)

    def init_weights(self, generator: torch.Generator) -> None:
        """Reference scheme (text_transformer.py:120-129): qkv ~ N(0, w^-0.5),
        out/c_proj ~ N(0, w^-0.5 (2L)^-0.5), c_fc ~ N(0, (2w)^-0.5); the
        experts' ``wi``/``wo`` as c_fc/c_proj, the router N(0, w^-0.5)."""
        width = self.ln_1.normalized_shape[0]
        attn_std = width ** -0.5
        proj_std = (width ** -0.5) * ((2 * self.total_layers) ** -0.5)
        fc_std = (2 * width) ** -0.5
        nn.init.normal_(self.attn.in_proj_weight, std=attn_std,
                        generator=generator)
        nn.init.zeros_(self.attn.in_proj_bias)
        init_linear(self.attn.out_proj, proj_std, generator)
        if hasattr(self, "moe"):
            self.moe.init_weights(generator, fc_std, proj_std)
        else:
            init_linear(self.mlp.c_fc, fc_std, generator)
            init_linear(self.mlp.c_proj, proj_std, generator)
        for ln in (self.ln_1, self.ln_2):
            ln.reset_parameters()

    def forward(self, x: torch.Tensor):
        x = x + self.attn(self.ln_1(x), causal=self.causal)
        if hasattr(self, "moe"):
            y, aux = self.moe(self.ln_2(x))
            return x + y, aux
        return x + self.mlp(self.ln_2(x)), None


class Transformer(nn.Module):
    """Stack of residual blocks (``resblocks.{i}``).

    ``checkpoint=True`` is the reference's ``checkpoint:`` kwarg (torch
    ``checkpoint_sequential``, base_transformer.py:66-73; full remat in the
    JAX package): under autograd each block runs in
    ``torch.utils.checkpoint``, keeping only its input and recomputing the
    rest, its attention forward kernel included, in the backward.
    ``remat_policy`` is an XLA memory knob of the JAX package (see
    REMAT_POLICIES); it is checked so that its configs build, and changes
    no result here.

    MoE (``moe_experts`` > 0, every layer; layers.py:318-324, 388-418 of
    the JAX package): a training forward appends ``moe_aux_weight`` times
    the depth-summed aux loss to ``moe_aux``, as JAX sows it into its
    ``moe`` collection; the train step takes the model's sum
    (:func:`pop_moe_aux`). An eval forward adds nothing."""

    def __init__(self, width: int, layers: int, heads: int,
                 causal: bool = False, attn_impl: str = "auto",
                 dtype: torch.dtype = torch.float32, checkpoint: bool = False,
                 remat_policy: str = "policy", device=None,
                 moe_experts: int = 0, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25,
                 moe_aux_weight: float = 0.01):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"remat_policy {remat_policy!r} not in {REMAT_POLICIES}")
        self.checkpoint = checkpoint
        self.moe_aux_weight = moe_aux_weight
        self.moe_aux: list = []
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, layers, causal, attn_impl,
                                   dtype, device, moe_experts, moe_top_k,
                                   moe_capacity_factor)
            for _ in range(layers))

    def init_weights(self, generator: torch.Generator) -> None:
        for block in self.resblocks:
            block.init_weights(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        remat = self.checkpoint and torch.is_grad_enabled()
        auxes = []
        for block in self.resblocks:
            if remat:
                x, aux = torch.utils.checkpoint.checkpoint(
                    block, x, use_reentrant=False)
            else:
                x, aux = block(x)
            if aux is not None:
                auxes.append(aux)
        if auxes:
            self.moe_aux.append(self.moe_aux_weight * torch.stack(auxes).sum())
        return x


def pop_moe_aux(model: nn.Module) -> Optional[torch.Tensor]:
    """The sum of the MoE aux losses that ``model``'s towers added since the
    last call, which it clears; None where no MoE tower ran in training."""
    out = None
    for m in model.modules():
        if isinstance(m, Transformer) and m.moe_aux:
            total = torch.stack(m.moe_aux).sum()
            out = total if out is None else out + total
            m.moe_aux = []
    return out
