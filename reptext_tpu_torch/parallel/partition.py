"""Tensor and data parallelism of the MMDiT stacks: the rules and the layers.

Counterpart of ``reptext_tpu/parallel/partition.py``. The JAX package states
Megatron-style tensor parallelism as sharding annotations and XLA inserts
the collectives; here the rules place each parameter and the layers run the
collectives themselves.

- **The rules** (:func:`split_rule`) are the JAX regular expressions, read on
  the port's parameter names, which follow the Flax tree
  (``double_blocks.3.block.to_q.weight`` is ``/double_blocks/block/to_q/kernel``):
  column-parallel (output features split over ``tp``) for ``to_q``,
  ``to_k``, ``to_v``, ``add_q_proj``, ``add_k_proj``, ``add_v_proj``,
  ``proj_mlp`` and ``ff(_context).in_proj``; row-parallel (input features
  split, partial sums) for ``to_out``, ``to_add_out``, ``ff(_context).out_proj``
  and the single block's ``proj_out``; everything else, biases included,
  replicated. :func:`param_shardings` gives each parameter its split dim in
  the port's [out, in] layout (0 for column, 1 for row), or None.
- **fp8 storage** (``QuantLinear``: ``kernel_q8`` codes [out, in] and
  ``kernel_scale`` [out, 1]) is split with the weight it stores: the codes as
  the dense weight, the per-output-channel scales with the rows of a column
  layer and whole in a row layer. The JAX rules match only ``kernel`` leaves,
  so JAX replicates its fp8 leaves; the product is the same.
- **Megatron's conjugate pair**: :func:`copy_to_tp` (``f``: identity
  forward, a tp all-reduce of the input gradient backward) before each
  column-parallel group, so that replicated parameters upstream (AdaLN,
  norms, embedders) get their whole gradient, and :func:`reduce_from_tp`
  (``g``: the tp all-reduce of the partial products forward, identity
  backward) inside each row-parallel layer, whose bias is added once, after
  it. A column layer's bias stays whole, as the JAX rules keep every bias,
  and is narrowed at use; its gradient is summed over tp.
- :func:`shard_module` makes a rank's tensor-parallel copy of a FLUX
  transformer, a ControlNet (union ones too) or a ``MultiControlNet``, and
  leaves the original as it is.
- :func:`shard_batch` and :class:`DPRows` split batch rows over ``dp``.
- :class:`ShardedState` and :class:`ShardedOptimizerState` give a sharded
  module's and its optimizer's state as whole tensors (the elastic trainer's
  restore points, which are layout-free, as the JAX checkpoint is).
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from reptext_tpu_torch.nn.layers import QuantLinear
from reptext_tpu_torch.io.quantize import QUANT_KEY, SCALE_KEY
from reptext_tpu_torch.parallel.group import SPGroup

COLUMN, ROW = "column", "row"
_COLUMN_RES = (re.compile(r"/(to_q|to_k|to_v|add_q_proj|add_k_proj|add_v_proj|proj_mlp)/kernel$"),
               re.compile(r"/ff(_context)?/in_proj/kernel$"))
_ROW_RES = (re.compile(r"/(to_out|to_add_out)/kernel$"),
            re.compile(r"/ff(_context)?/out_proj/kernel$"),
            re.compile(r"single_blocks/block/proj_out/kernel$"))
_SINGLE_PROJ_OUT = re.compile(r"single_blocks/block/proj_out/kernel$")


def flax_path(layer: str) -> str:
    """A Linear's module name -> the Flax path of its kernel:
    ``double_blocks.3.block.to_q`` -> ``/double_blocks/block/to_q/kernel``
    (the scanned layer index dropped, as the stacked leaf has none)."""
    parts = [p for p in layer.split(".") if p and not p.isdigit()]
    return "/" + "/".join(parts + ["kernel"])


def split_rule(layer: str) -> Optional[str]:
    """COLUMN, ROW or None (replicated) for the Linear named ``layer``."""
    path = flax_path(layer)
    if any(r.search(path) for r in _COLUMN_RES):
        return COLUMN
    if any(r.search(path) for r in _ROW_RES):
        return ROW
    return None


def _segments(layer: str, linear: nn.Module) -> Tuple[int, ...]:
    """The pieces of a row layer's input that each split on their own: the
    single block's ``proj_out`` takes cat([attention heads, MLP features]),
    so rank r's rows are its heads' plus its features'; one piece elsewhere."""
    if _SINGLE_PROJ_OUT.search(flax_path(layer)):
        mlp = linear.in_features - linear.out_features   # inner == dim in FLUX
        return (linear.in_features - mlp, mlp)
    return (linear.in_features,)


def param_shardings(module: nn.Module) -> Dict[str, Optional[int]]:
    """{parameter name: the dim split over tp, or None}: the counterpart of
    the JAX ``param_shardings``, on an unsharded module. [out, in] layout:
    column weights and codes split on 0, row ones on 1; a column layer's fp8
    scales on 0; biases, norms and everything the rules leave alone None."""
    out: Dict[str, Optional[int]] = {}
    for name, mod in module.named_modules():
        rule = split_rule(name) if isinstance(mod, (nn.Linear, QuantLinear)) else None
        for leaf, _ in mod.named_parameters(recurse=False):
            dim = None
            if rule is not None and leaf in ("weight", QUANT_KEY):
                dim = 0 if rule == COLUMN else 1
            elif rule == COLUMN and leaf == SCALE_KEY:
                dim = 0
            out[f"{name}.{leaf}" if name else leaf] = dim
    return out


# ------------------------------------------------------------------ f and g

class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce_sum(grad), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce_sum(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.width = group.rank, x.shape[-1]
        return group.all_gather(x, x.ndim - 1)

    @staticmethod
    def backward(ctx, grad):      # the gathered tensor's gradient is replicated
        return grad.narrow(-1, ctx.rank * ctx.width, ctx.width), None


def copy_to_tp(x: torch.Tensor, group: SPGroup) -> torch.Tensor:
    """Megatron's ``f``: ``x`` forward; the input gradient summed over tp."""
    return x if group.size == 1 else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group: SPGroup) -> torch.Tensor:
    """Megatron's ``g``: the sum of the ranks' partial ``x`` forward; the
    gradient passed through."""
    return x if group.size == 1 else _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group: SPGroup) -> torch.Tensor:
    """The ranks' last-dim slices concatenated in rank order (the IP-Adapter
    path's per-head output onto the replicated stream)."""
    return x if group.size == 1 else _GatherFromTP.apply(x, group)


# -------------------------------------------------------- the parallel layers

def _slice(t: torch.Tensor, dim: int, segments: Sequence[int], rank: int, size: int
           ) -> torch.Tensor:
    """Rank ``rank``'s part of each segment of ``t`` along ``dim``, joined: a
    new tensor that does not keep ``t`` alive."""
    pieces, off = [], 0
    for seg in segments:
        n = seg // size
        pieces.append(t.narrow(dim, off + rank * n, n))
        off += seg
    return (torch.cat(pieces, dim) if len(pieces) > 1
            else pieces[0].clone(memory_format=torch.contiguous_format))


def _unslice(parts: Sequence[torch.Tensor], dim: int, segments: Sequence[int]) -> torch.Tensor:
    """The whole tensor from every rank's :func:`_slice`, in rank order."""
    size, out, off = len(parts), [], 0
    for seg in segments:
        n = seg // size
        out += [p.narrow(dim, off, n) for p in parts]
        off += n
    return torch.cat(out, dim)


class _TPLayer:
    """What the column and row layers share: the rank, the group and, per
    parameter, its split (dim, the whole tensor's segments along it)."""

    tp_rank: int
    tp_size: int
    tp_group: SPGroup
    tp_splits: Dict[str, Tuple[int, Tuple[int, ...]]]

    def _init_tp(self, rank: int, size: int, group: SPGroup, splits) -> None:
        nn.Module.__init__(self)
        self.tp_rank, self.tp_size, self.tp_group, self.tp_splits = rank, size, group, splits

    def _local_bias(self) -> Optional[torch.Tensor]:
        """A column layer's whole bias narrowed to the rank's features; its
        gradient summed over tp when it is trained."""
        b = self.bias
        if b is None:
            return None
        if b.requires_grad:
            b = copy_to_tp(b, self.tp_group)
        n = self.out_features
        return b.narrow(0, self.tp_rank * n, n)

    def _reduced(self, y: torch.Tensor) -> torch.Tensor:
        y = reduce_from_tp(y, self.tp_group)
        return y if self.bias is None else y + self.bias

    def extra_repr(self) -> str:
        return f"{super().extra_repr()}, tp rank {self.tp_rank} of {self.tp_size}"


class ColumnParallelLinear(_TPLayer, nn.Linear):
    """This rank's output features of a Linear: weight [out / tp, in], the
    bias whole [out]."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self._local_bias())


class RowParallelLinear(_TPLayer, nn.Linear):
    """This rank's input features of a Linear: weight [out, in / tp]; the
    partial product summed over tp (``g``), then the whole bias."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduced(F.linear(x, self.weight))


class QuantColumnParallelLinear(_TPLayer, QuantLinear):
    """:class:`ColumnParallelLinear` over fp8 storage: the rank's rows of the
    codes and of the per-output-channel scales."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.dequantized(x.dtype), self._local_bias())


class QuantRowParallelLinear(_TPLayer, QuantLinear):
    """:class:`RowParallelLinear` over fp8 storage: the rank's columns of the
    codes, the scales whole."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduced(F.linear(x, self.dequantized(x.dtype)))


def parallel_linear(linear: nn.Module, rule: str, segments: Sequence[int], rank: int,
                    size: int, group: SPGroup, take=None) -> nn.Module:
    """The rank's ``rule`` (COLUMN or ROW) layer of ``linear`` (an
    ``nn.Linear`` or a ``QuantLinear``). ``take(whole, make)`` gives the
    slice of each split tensor (a cache shared by dp replicas), ``make()``
    by default."""
    quant = isinstance(linear, QuantLinear)
    cls = {(COLUMN, False): ColumnParallelLinear, (ROW, False): RowParallelLinear,
           (COLUMN, True): QuantColumnParallelLinear, (ROW, True): QuantRowParallelLinear}[
               (rule, quant)]
    dim = 0 if rule == COLUMN else 1
    whole = linear.out_features if rule == COLUMN else linear.in_features
    if whole % size:
        raise ValueError(f"tp={size} does not divide the {whole} "
                         f"{'output' if rule == COLUMN else 'input'} features of a {rule}-"
                         "parallel layer")
    segs = tuple(segments) if rule == ROW else (whole,)
    splits = {QUANT_KEY if quant else "weight": (dim, segs)}
    if quant and rule == COLUMN:
        splits[SCALE_KEY] = (0, segs)
    layer = cls.__new__(cls)
    layer._init_tp(rank, size, group, splits)
    take = take or (lambda whole, make: make())
    for leaf, p in linear.named_parameters(recurse=False):
        if leaf in splits:
            d, s = splits[leaf]
            value = take(p, lambda p=p, d=d, s=s: _slice(p.detach(), d, s, rank, size))
            p = nn.Parameter(value, requires_grad=p.requires_grad)
        setattr(layer, leaf, p)
    layer.in_features = linear.in_features // (size if rule == ROW else 1)
    layer.out_features = linear.out_features // (size if rule == COLUMN else 1)
    return layer


def shard_module(model, mesh, trainable: bool = False):
    """This rank's tensor-parallel copy of ``model`` (a FLUX transformer, a
    ControlNet or a ``MultiControlNet``) over ``mesh``'s tp group.

    A new module: every Linear the rules split is replaced by this rank's
    column or row layer (fp8 ones too), every block runs its heads
    (``num_heads / tp``) and its MLP features, and everything else (the
    embedders, AdaLN, norms, heads) is the original's module, shared, or with
    ``trainable`` a copy of its own, so that the ranks' gradients and
    optimizer steps never meet in one tensor. The original, which other
    pipelines may share, is not changed, and once nothing else holds it its
    whole split weights are freed. Raises when tp does not divide the heads
    or the MLP width (the JAX package would pad them unevenly). At tp = 1 a
    module that is not trained is returned as it is. In a thread mesh the dp
    replicas of one tp rank share the slices of a module that is not trained.
    """
    from reptext_tpu_torch.models.multi_controlnet import MultiControlNet
    from reptext_tpu_torch.nn.blocks import JointTransformerBlock, SingleTransformerBlock

    if isinstance(model, MultiControlNet):
        entries = [dataclasses.replace(e, model=shard_module(e.model, mesh, trainable))
                   for e in model.entries]
        return MultiControlNet(entries, model.base_num_layers, model.base_num_single_layers)
    rank, size, group = mesh.tp_rank, mesh.tp, mesh.tp_group
    done = getattr(model, "tp_sharded", None)
    if done is not None:
        if done != (rank, size):
            raise ValueError(f"this module is tp rank {done[0]} of {done[1]} already")
        return model
    if size == 1 and not trainable:
        return model
    cache = None if trainable else mesh.slices
    take = None if cache is None else (lambda whole, make: cache.get(whole, (rank, size), make))

    def param(p):
        if not trainable or p is None:
            return p
        return nn.Parameter(p.detach().clone(), requires_grad=p.requires_grad)

    def copy_tree(module: nn.Module, name: str) -> nn.Module:
        if isinstance(module, (nn.Linear, QuantLinear)):
            rule = split_rule(name)
            if rule is not None:
                layer = parallel_linear(module, rule, _segments(name, module), rank, size,
                                        group, take)
                for leaf, p in list(layer._parameters.items()):
                    if leaf not in layer.tp_splits:       # the whole bias
                        layer._parameters[leaf] = param(p)
                return layer
        new = copy.copy(module)
        new._parameters = {k: param(p) for k, p in module._parameters.items()}
        new._buffers = dict(module._buffers)
        new._modules = {k: None if m is None else copy_tree(m, f"{name}.{k}" if name else k)
                        for k, m in module._modules.items()}
        if isinstance(module, (JointTransformerBlock, SingleTransformerBlock)):
            if module.num_heads % size:
                raise ValueError(f"tp={size} does not divide the {module.num_heads} heads "
                                 "(the JAX package would shard them unevenly; the port refuses)")
            new.num_heads = module.num_heads // size
            new.tp_rank, new.tp_size, new.tp_group = rank, size, group
        return new

    new = copy_tree(model, "")
    new.tp_sharded = (rank, size)
    return new


# --------------------------------------------------------- data parallelism

POSITION_KEYS = ("img_ids", "txt_ids")


def shard_batch(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's rows of a training batch: every tensor whose leading axis
    is the batch (``x0``'s rows) split over ``dp``, in rank order; rank-0
    leaves, the RoPE position tables and None whole. The JAX function
    annotates every leaf of rank >= 2 as split and leaves rank-1 leaves
    replicated, which XLA resolves per operation; a rank here holds only
    what it computes on, so the per-row vectors (guidance) are split too and
    the position tables, whose rows are tokens, are not."""
    rows = batch["x0"].shape[0]
    if rows % mesh.dp:
        raise ValueError(f"batch of {rows} rows not divisible by dp={mesh.dp}")

    def put(key, x):
        if (isinstance(x, torch.Tensor) and x.ndim >= 1 and key not in POSITION_KEYS
                and x.shape[0] == rows):
            return mesh.dp_group.shard(x, 0)
        return x

    return {k: put(k, v) for k, v in batch.items()}


# the batch-row arguments of a FLUX call and of a ControlNet call, by position
FLUX_ROW_ARGS = (0, 1, 2, 3, 6)
CONTROLNET_ROW_ARGS = (0, 1, 2, 3, 4, 7)
_STACK_KWARGS = ("controlnet_block_samples", "controlnet_single_block_samples")


class DPRows:
    """A model call with its batch rows split over a dp group: each dp rank
    runs its rows, and the output rows are gathered, so every rank returns the
    whole result. Rows split only where dp divides them; otherwise every rank
    runs them all (JAX's inference mesh shards only the weights, so the result
    is the same either way). ``row_args``: the positions of the row arguments
    (:data:`FLUX_ROW_ARGS`, :data:`CONTROLNET_ROW_ARGS`); the residual stacks
    [L, B, ...] split on dim 1, ``mode`` and a per-row ``ip_scale`` and
    ``ip_tokens`` on dim 0. Attributes read through to the model."""

    def __init__(self, model, group: SPGroup, row_args: Sequence[int]):
        self.model, self.group, self.row_args = model, group, tuple(row_args)

    def __getattr__(self, name):
        return getattr(self.__dict__["model"], name)

    def __call__(self, *args, **kw):
        g, rows = self.group, args[0].shape[0]
        if g.size == 1 or rows % g.size:
            return self.model(*args, **kw)

        def part(x, dim=0):
            if isinstance(x, (tuple, list)):
                return tuple(part(s, dim) for s in x)
            if isinstance(x, torch.Tensor) and x.ndim > dim and x.shape[dim] == rows:
                return g.shard(x, dim)
            return x

        args = tuple(part(a) if i in self.row_args else a for i, a in enumerate(args))
        kw = {k: part(v, 1 if k in _STACK_KWARGS else 0) for k, v in kw.items()}
        out = self.model(*args, **kw)
        if isinstance(out, tuple):          # a ControlNet's residual stacks
            return tuple(g.all_gather(o, 1) for o in out)
        return g.all_gather(out, 0)


# --------------------------------------------------- whole state of a shard

def tp_placements(module: nn.Module) -> Dict[str, Tuple[int, Tuple[int, ...]]]:
    """{parameter name: (dim, whole segments)} of a sharded module's split
    parameters."""
    out = {}
    for name, mod in module.named_modules():
        for leaf, split in getattr(mod, "tp_splits", {}).items():
            out[f"{name}.{leaf}" if name else leaf] = split
    return out


class ShardedState:
    """``state_dict``/``load_state_dict`` of a rank's sharded module in whole
    tensors: the split ones gathered over tp (every rank takes part; all get
    the whole state), and a whole state loaded as the rank's slices. So a
    state saved under one layout loads under any other, or unsharded."""

    def __init__(self, module: nn.Module, mesh):
        self.module, self.group = module, mesh.tp_group
        self.splits = tp_placements(module)

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        if name not in self.splits:
            return t
        dim, segs = self.splits[name]
        g = self.group
        return _unslice(g.all_gather(t.detach().unsqueeze(0), 0).unbind(0), dim, segs)

    def part(self, name: str, t: torch.Tensor) -> torch.Tensor:
        if name not in self.splits:
            return t
        dim, segs = self.splits[name]
        return _slice(t, dim, segs, self.group.rank, self.group.size)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {k: self.whole(k, v) for k, v in self.module.state_dict().items()}

    def load_state_dict(self, state: Dict[str, torch.Tensor]):
        return self.module.load_state_dict({k: self.part(k, v) for k, v in state.items()})


class ShardedOptimizerState:
    """The optimizer of a sharded module with its per-parameter state (Adam's
    moments) in whole tensors, as :class:`ShardedState` gives the module's."""

    def __init__(self, optimizer: torch.optim.Optimizer, module: nn.Module, mesh):
        self.optimizer, self.view = optimizer, ShardedState(module, mesh)
        by_id = {id(p): n for n, p in module.named_parameters()}
        self.names = [by_id[id(p)] for grp in optimizer.param_groups for p in grp["params"]]

    def _map(self, state: dict, fn) -> dict:
        out = {"param_groups": state["param_groups"], "state": {}}
        for idx, entry in state["state"].items():
            name = self.names[idx]
            out["state"][idx] = {k: fn(name, v) if isinstance(v, torch.Tensor) and v.ndim > 0
                                 else v for k, v in entry.items()}
        return out

    def state_dict(self) -> dict:
        return self._map(self.optimizer.state_dict(), self.view.whole)

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(self._map(state, self.view.part))


def all_reduce_grads(params: List[torch.Tensor], group: SPGroup) -> None:
    """Each gradient summed over ``group`` (the dp ranks' partial gradients of
    one loss), in place."""
    if group.size == 1:
        return
    for p in params:
        if p.grad is not None:
            p.grad.copy_(group.all_reduce_sum(p.grad))
