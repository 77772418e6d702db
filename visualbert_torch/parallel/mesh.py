"""The (data, model) mesh over ``torch.distributed`` process groups
(counterpart of ``visualbert_tpu/parallel/mesh.py``).

JAX runs one pjit program over a ``jax.sharding.Mesh`` with two axes; the
port runs one process a GPU and lays the ranks out as the same mesh,
``np.arange(world).reshape(d, m)`` (process-major, as ``jax.devices()``
is):

  * ``data``: each data index holds a contiguous slice of the global batch
    (``Batcher(process_shard=mesh.batch_shard())``); the gradients are
    summed over the data group after the backward (``train/trainer.py``),
    and every mean's denominator is global (``models/losses.py``).
  * ``model``: tensor parallel, Megatron's column/row split of each encoder
    layer: the attention heads and the FFN width are split over the model
    group, every other tensor (the hidden state, LayerNorms, embeddings,
    heads) is replicated there (``models/encoder.py``).

:data:`LOGICAL_AXIS_RULES` maps the JAX package's two split logical axes,
``heads`` and ``mlp``, to the ``model`` mesh axis (JAX's other rules
replicate, or split ``batch`` over ``data``, which the Batcher does),
and :data:`PARAMETER_AXES` says which torch parameter carries which
split logical axis and along which dimension; :func:`shard_params`,
:func:`gather_params` and :func:`shard_module` read both. **The vocabulary
stays replicated**, unlike JAX's ``("vocab", "model")`` rule: the fused
cross-entropy K4-K6 takes the whole table, as it does inside JAX's own
``shard_map`` (``ops/mlm_xent.py:342-348``, ``in_specs`` ``P(None, None)``),
and the table is 94 MB at bert-base.

Collectives go through ``all_reduce`` (an all-gather is an all-reduce of
zero-padded slices, exact) and ``broadcast``, the two that gloo also runs
on CUDA tensors, so two ranks can share one card for a check.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from visualbert_torch.parallel import distributed
from visualbert_torch.utils.logging import get_logger

log = get_logger(__name__)

# Logical axis name -> mesh axis: the two JAX rules the port splits by;
# every other logical axis is replicated (see the module docstring).
LOGICAL_AXIS_RULES = (("heads", "model"), ("mlp", "model"))

# Parameter name suffix (a regex on the HF/reference names of
# ``tools/weights.py``) -> (logical axis, dimension it lies on). Every model
# of the port builds its layers from ``models/encoder.py::TransformerLayer``.
PARAMETER_AXES = (
    (r"attention\.self\.(?:query|key|value)\.(?:weight|bias)", "heads", 0),  # column-parallel: heads
    (r"attention\.output\.dense\.weight", "heads", 1),                       # row-parallel: heads
    (r"intermediate\.dense\.(?:weight|bias)", "mlp", 0),                     # column-parallel: FFN width
    (r"(?:layer\.\d+|additional_layer)\.output\.dense\.weight", "mlp", 1),  # row-parallel: FFN width
)
_PARAMETER_AXES = [(re.compile(r"(?:^|\.)" + p + r"$"), axis, dim) for p, axis, dim in PARAMETER_AXES]

# dropout seed strides of the data and model index (JAX
# ``ops/flash_attention.py:740``, ``ops/dropout.py:140``)
DATA_SEED_STRIDE = 1_000_003
MODEL_SEED_STRIDE = 10_000_019
SEED_MODULUS = 2**31 - 1


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a (data, model) mesh: its indices along both
    axes and the process groups of its data and model peers (None for an
    axis of size 1)."""

    shape: Tuple[int, int]
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None
    model_root: int = 0  # the global rank of model index 0 in this rank's model group

    @property
    def data_size(self) -> int:
        return self.shape[0]

    @property
    def model_size(self) -> int:
        return self.shape[1]

    def batch_shard(self) -> Optional[Tuple[int, int]]:
        """``Batcher(process_shard=...)`` of this rank: (data index, data
        size), or None on one data index. Model peers read the same rows."""
        return (self.data_index, self.data_size) if self.data_size > 1 else None

    def data_seed(self, seed: int) -> int:
        """A dropout seed for a site whose tensor is replicated over the
        model group: offset by the data index only, so model peers draw the
        same mask."""
        return (int(seed) + self.data_index * DATA_SEED_STRIDE) % SEED_MODULUS

    def shard_seed(self, seed: int) -> int:
        """A dropout seed for a tensor split over both axes (attention
        probabilities on the rank's heads)."""
        return (self.data_seed(seed) + self.model_index * MODEL_SEED_STRIDE) % SEED_MODULUS


def create_mesh(mesh_shape: Tuple[int, int] = (1, 1)) -> Mesh:
    """This rank's :class:`Mesh` of ``mesh_shape`` = (d, m) over the world of
    ``torch.distributed`` (one process when it is not up). ``d * m`` must
    equal the world size; otherwise, as JAX's ``create_mesh`` does, every
    rank goes on the data axis ((world, 1)), with a warning. Every rank
    must call this, in the same order: it creates the process groups."""
    d, m = (int(x) for x in mesh_shape)
    n, r = distributed.world_size(), distributed.rank()
    if d * m != n:
        if (d, m) != (1, 1) or n > 1:
            log.warning("mesh_shape %s does not cover the %d rank(s): using (%d, 1)", (d, m), n, n)
        d, m = n, 1
    ranks = np.arange(n).reshape(d, m)
    data_group = model_group = None
    # new_group is collective: every rank creates every group, in order
    if d > 1:
        for j in range(m):
            g = dist.new_group([int(x) for x in ranks[:, j]])
            if r in ranks[:, j]:
                data_group = g
    if m > 1:
        for i in range(d):
            g = dist.new_group([int(x) for x in ranks[i, :]])
            if r in ranks[i, :]:
                model_group = g
    di, mi = (int(x) for x in np.argwhere(ranks == r)[0])
    return Mesh((d, m), di, mi, data_group, model_group, int(ranks[di, 0]))


def model_split_dim(name: str) -> Optional[int]:
    """The dimension along which parameter ``name`` is split over the model
    axis, or None when it is replicated there."""
    for pattern, axis, dim in _PARAMETER_AXES:
        if pattern.search(name) and dict(LOGICAL_AXIS_RULES).get(axis) == "model":
            return dim
    return None


def _tp(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.model_size > 1


# ------------------------------------------------------------ collectives


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (nothing for a None group); 16-bit
    floats are summed in fp32 and rounded once."""
    if group is not None:
        if t.dtype in (torch.bfloat16, torch.float16):
            wide = t.float()
            dist.all_reduce(wide, group=group)
            t.copy_(wide)
        else:
            dist.all_reduce(t, group=group)
    return t


def gather_slices(x: torch.Tensor, dim: int, index: int, size: int, group) -> torch.Tensor:
    """The concatenation along ``dim`` of every peer's ``x`` (equal shapes),
    as an all-reduce of zero-padded slices: exact, and gloo runs it on
    CUDA tensors too."""
    if group is None or size == 1:
        return x
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * size
    full = x.new_zeros(shape)
    full.narrow(dim, index * n, n).copy_(x)
    return all_reduce(full, group)


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce backward: the input of a column-parallel
    product (each model rank's partial gradient of a replicated tensor)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward, identity backward: the output of a row-parallel
    product (partial sums over the model group's slices)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh.model_group) if _tp(mesh) else x


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh.model_group) if _tp(mesh) else x


# ---------------------------------------------------- parameters and states


def shard_params(state: Mapping[str, torch.Tensor], mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """A full state dict (the HF/reference names, as ``load_state_dict``
    takes them) -> this rank's shard: every tensor split over the model
    axis cut to the model index's contiguous block (whole heads, a slice of
    the FFN width); the rest as given."""
    out = {}
    for k, v in state.items():
        dim = model_split_dim(k) if _tp(mesh) else None
        out[k] = v if dim is None else v.chunk(mesh.model_size, dim)[mesh.model_index].clone()
    return out


def gather_params(state: Mapping[str, torch.Tensor], mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_params`, collective over the model group
    (every model peer calls it with its shard, the names in one order):
    the full state dict on every peer."""
    out = {}
    for k, v in state.items():
        dim = model_split_dim(k) if _tp(mesh) else None
        out[k] = v if dim is None else gather_slices(v.contiguous(), dim, mesh.model_index, mesh.model_size,
                                                     mesh.model_group)
    return out


def split_parameter_names(module: torch.nn.Module, mesh: Optional[Mesh]) -> set:
    """The names of ``module``'s parameters that are split over the model
    axis of ``mesh`` (none without tensor parallelism)."""
    if not _tp(mesh):
        return set()
    return {k for k, _ in module.named_parameters() if model_split_dim(k) is not None}


def _set_mesh(module: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    for mod in module.modules():
        if hasattr(type(mod), "mesh"):
            mod.mesh = mesh


def shard_module(module: torch.nn.Module, mesh: Optional[Mesh]) -> torch.nn.Module:
    """Cut ``module``'s full parameters to this rank's shard in place (the
    Parameter objects stay, so an optimizer built on them still holds
    them) and hand ``mesh`` to every submodule that reads one (a class
    attribute ``mesh``): the encoder's collectives and the kernels' mesh
    argument. With a mesh whose model axis is 1 no parameter changes."""
    with torch.no_grad():
        for k, p in module.named_parameters():
            dim = model_split_dim(k) if _tp(mesh) else None
            if dim is not None:
                if p.shape[dim] % mesh.model_size:
                    raise ValueError(f"{k} {tuple(p.shape)}: dimension {dim} does not split over "
                                     f"{mesh.model_size} model ranks")
                p.data = p.data.chunk(mesh.model_size, dim)[mesh.model_index].contiguous().clone()
    _set_mesh(module, mesh)
    return module


def unshard_module(module: torch.nn.Module, mesh: Optional[Mesh]) -> torch.nn.Module:
    """The inverse of :func:`shard_module`, in place and collective over the
    model group: full parameters on every peer, no mesh on the modules."""
    with torch.no_grad():
        for k, p in module.named_parameters():
            dim = model_split_dim(k) if _tp(mesh) else None
            if dim is not None:
                p.data = gather_slices(p.data.contiguous(), dim, mesh.model_index, mesh.model_size,
                                       mesh.model_group)
    _set_mesh(module, None)
    return module


def all_reduce_numbers(values, group, device="cpu") -> np.ndarray:
    """Host numbers summed over ``group`` (as float64), e.g. counts of
    hits; returned unchanged without a group."""
    a = np.asarray(values, np.float64)
    if group is None:
        return a
    t = torch.tensor(a, dtype=torch.float64, device=device)
    return all_reduce(t, group).cpu().numpy()

