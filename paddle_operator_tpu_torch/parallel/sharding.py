"""Logical-axis sharding rules — the port of
``paddle_operator_tpu/parallel/sharding.py``.

Parameters are sharded by *logical* axis names (``embed``, ``mlp``,
``heads`` …) mapped to mesh axes through a rule table, matched against
state-dict names by regex (first match wins; unmatched tensors are
replicated).  Default rule set (the standard LLM recipe):

    batch      → (dp, fsdp)   activations' batch dim
    seq        → cp           sequence dim under context parallelism
    embed      → fsdp         params' model dim (FSDP shards here)
    heads      → tp           attention heads (tensor parallel)
    kv_heads   → tp
    mlp        → tp           ffn hidden dim
    vocab      → tp           output projection
    expert     → ep
    layers     → pp           stacked-layer dim under pipeline parallelism
    (unlisted) → replicated

What differs from the JAX module:

- :func:`logical_to_mesh` returns the per-dimension tuple a JAX
  ``PartitionSpec`` holds (``None``, an axis name, or a tuple of axis
  names), without building a mesh: ``tuple(P(...))`` of the JAX result
  equals it.  Size-1 axes are dropped when a mesh (or its axis sizes,
  a mapping) is given; :func:`tree_specs` gives every tensor's tuple
  the same way.
- :func:`tree_shardings` maps each state-dict name to its DTensor
  placements (one ``Shard(dim)`` or ``Replicate()`` a mesh dimension,
  in :data:`parallel.mesh.AXIS_ORDER`), not to a ``NamedSharding``.  A
  dimension its mesh factor does not divide raises (JAX's partitioner
  refuses it too), except in the int8 moments' blocked shape, which
  JAX replicates there and so does :func:`q8_spec`.
- The int8 moments (``train/opt8bit.py``: codes ``[..., ceil(n/256),
  256]``, scales ``[..., ceil(n/256), 1]``) take JAX's q8 leaf rule
  (:func:`q8_spec`): the parameter's spec over the leading axes, its
  last-axis entry on the block-count dim, any axis the blocked shape
  cannot divide replicated.  Every block is a GLOBAL block, so a
  rank's blocks need not cover its parameter columns; :func:`q8_layout`
  says which of the three cases a parameter is in (:data:`ALIGNED`,
  :data:`REPLICATED`, :data:`UNALIGNED`) and which blocks and columns
  the rank holds, and the update (``train/trainer.py`` ``AdamW8bit``)
  gathers what its case needs.
- :func:`batch_sharding` gives the batch's placements; :func:`shard_batch`
  wraps this rank's rows of a global batch as DTensors with them (the
  port of placing a host batch onto the mesh).  A rank holds whole
  rows, replicated over ``cp``: the causal-LM train step cuts its cp
  chunk itself after the next-token shift, since a chunk's last target
  is the next chunk's first token.
- ``layers → pp``: the port's layers are separate modules, not a
  stacked axis, so the rule is a placement of whole layers: stage *s*
  holds layers ``[s·L/pp, (s+1)·L/pp)`` (``models/llama.py``
  ``layer_stage``), each a DTensor over the stage's sub-mesh
  (``parallel/mesh.py`` ``stage_mesh``) with the placements of the rest
  of its spec.  :func:`placement_by_axis` reads any parameter's
  placements by axis name, whichever mesh it lies on.
- Serving tensor parallelism (a ``parallel/mesh.py``
  ``make_serving_mesh`` mesh, one ``tp`` axis, one process a card):
  :func:`kv_cache_sharding` gives the kv heads this rank's KV cache
  holds (JAX's ``kv_cache_sharding`` of the stacked cache), and
  :func:`serving_specs` / :func:`serving_region` the cut of a serving
  tree by ``models/llama.py`` ``partition_patterns`` under
  :data:`SERVING_RULES` (``vocab``, ``heads``, ``kv_heads``, ``mlp`` to
  ``tp``; every other axis replicated), an axis the tp does not divide
  replicated, as JAX's ``replicate_indivisible=True``.  The attention
  projections stay whole when the kv heads do not split (the kernel
  must contract whole GQA groups: ``LlamaConfig.decode_tp_compatible``),
  where the JAX package shards their columns under GSPMD.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from paddle_operator_tpu_torch.parallel.mesh import (STAGE_AXES,
                                                     coordinates,
                                                     mesh_axis_sizes)
from paddle_operator_tpu_torch.train.opt8bit import blocked_shape

LogicalSpec = Tuple[Optional[str], ...]
MeshSpecTuple = Tuple[Any, ...]

# logical axis name -> mesh axis (or tuple of mesh axes)
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("dp", "fsdp"),
    "seq": "cp",
    "embed": "fsdp",
    "heads": "tp",
    "kv_heads": "tp",
    "mlp": "tp",
    "vocab": "tp",
    "expert": "ep",
    "layers": "pp",
}


# the serving mesh's rules: one tp axis over heads, ffn and vocab
SERVING_RULES: Dict[str, Any] = {
    "heads": "tp",
    "kv_heads": "tp",
    "mlp": "tp",
    "vocab": "tp",
}

# the attention projections (whole on every rank when the kv heads do
# not split over tp)
_ATTN = re.compile(r"attn\.w[qkvo]\.")


def _sizes(mesh) -> Optional[Dict[str, int]]:
    """Axis sizes of a DeviceMesh, or of a mapping that already is
    them."""
    if mesh is None:
        return None
    return dict(mesh) if isinstance(mesh, Mapping) else mesh_axis_sizes(mesh)


def logical_to_mesh(spec: LogicalSpec,
                    rules: Optional[Dict[str, Any]] = None,
                    mesh=None) -> MeshSpecTuple:
    """Translate a logical spec like ("embed", "mlp") into a per-dim
    tuple of mesh axes.

    Axes whose mesh size is 1 are dropped (replicated) so the same rules
    work on any mesh, including single-device.  ``mesh``: a DeviceMesh
    or its axis sizes.
    """
    rules = rules if rules is not None else DEFAULT_RULES
    sizes = _sizes(mesh)

    def live(mesh_axis: Any):
        if mesh_axis is None:
            return None
        if isinstance(mesh_axis, (tuple, list)):
            kept = tuple(a for a in mesh_axis
                         if sizes is None or sizes.get(a, 1) > 1)
            # one axis left is that axis (as PartitionSpec holds it)
            return (kept[0] if len(kept) == 1 else kept) if kept else None
        if sizes is not None and sizes.get(mesh_axis, 1) <= 1:
            return None
        return mesh_axis

    return tuple(live(rules.get(ax)) if ax is not None else None
                 for ax in spec)


def spec_for_path(path_patterns: Sequence[Tuple[str, LogicalSpec]],
                  path: str) -> LogicalSpec:
    """First-match lookup of a state-dict name against (regex, logical
    spec)."""
    for pat, spec in path_patterns:
        if re.search(pat, path):
            return spec
    return ()


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def placements(spec: MeshSpecTuple, mesh
               ) -> Tuple[Placement, ...]:
    """DTensor placements of a tensor whose dim *d* is sharded over the
    mesh axes of ``spec[d]``, on ``mesh`` (a DeviceMesh, or its axis
    names).  Axes sharding one dim must come in mesh order (outer
    first), as DTensor nests them."""
    names = list(getattr(mesh, "mesh_dim_names", mesh))
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        last = -1
        for a in _axes(entry):
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {a!r} shards two dims of "
                                 f"{spec}")
            if i < last:
                raise ValueError(f"axes {entry} of dim {d} are not in mesh "
                                 f"order {tuple(names)}")
            out[i], last = Shard(d), i
    return tuple(out)


def spec_of(pl: Sequence[Placement], mesh,
            ndim: int) -> MeshSpecTuple:
    """The per-dim tuple of mesh axes of ``pl`` on ``mesh`` (a
    DeviceMesh, or its axis names; the inverse of :func:`placements`);
    a dim sharded by one axis gives its name, by several a tuple."""
    dims: list = [[] for _ in range(ndim)]
    for name, p in zip(getattr(mesh, "mesh_dim_names", mesh), pl):
        if isinstance(p, Shard):
            dims[p.dim].append(name)
    return tuple(None if not a else (a[0] if len(a) == 1 else tuple(a))
                 for a in dims)


def tree_specs(shapes: Mapping[str, Any], mesh,
               path_patterns: Sequence[Tuple[str, LogicalSpec]],
               rules: Optional[Dict[str, Any]] = None
               ) -> Dict[str, MeshSpecTuple]:
    """The per-dim mesh axes of every name of ``shapes`` (a state dict,
    or name -> shape) on ``mesh`` (a DeviceMesh or its axis sizes): the
    JAX ``leaf_sharding``'s spec, the first matching pattern's (none:
    replicated), cut or padded with None to the tensor's rank.  A dim
    whose size its mesh factor does not divide raises ``ValueError``
    naming it."""
    sizes = _sizes(mesh)
    out = {}
    for name, t in shapes.items():
        shape = tuple(getattr(t, "shape", t))
        pspec = list(logical_to_mesh(spec_for_path(path_patterns, name),
                                     rules, sizes))[:len(shape)]
        spec = tuple(pspec + [None] * (len(shape) - len(pspec)))
        for d, entry in enumerate(spec):
            n = int(np.prod([sizes[a] for a in _axes(entry)]))
            if shape[d] % n:
                raise ValueError(f"{name}: dim {d} of size {shape[d]} is "
                                 f"not divisible by its mesh factor {n} "
                                 f"({entry})")
        out[name] = spec
    return out


def tree_shardings(shapes: Mapping[str, Any], mesh: DeviceMesh,
                   path_patterns: Sequence[Tuple[str, LogicalSpec]],
                   rules: Optional[Dict[str, Any]] = None,
                   stage_names=()) -> Dict[str, Tuple[Placement, ...]]:
    """DTensor placements for every name of ``shapes``
    (:func:`tree_specs` on ``mesh``); a name of ``stage_names`` (a pp
    stage's layer) gets them over the stage's axes
    (``parallel.mesh.STAGE_AXES``)."""
    return {name: placements(spec, STAGE_AXES if name in stage_names
                             else mesh)
            for name, spec in tree_specs(shapes, mesh, path_patterns,
                                         rules).items()}


def batch_sharding(mesh: DeviceMesh,
                   seq_axis: bool = False) -> Tuple[Placement, ...]:
    """Placements of a [batch, seq, ...] input batch: batch over (dp,
    fsdp), and with ``seq_axis`` seq over cp.  The JAX signature's
    ``extra_dims`` only pads its PartitionSpec with None."""
    spec = ("batch", "seq") if seq_axis else ("batch",)
    return placements(logical_to_mesh(spec, None, mesh), mesh)


def placement_by_axis(p: torch.Tensor) -> Dict[str, Placement]:
    """Axis name -> placement of DTensor ``p`` over its own mesh (a
    stage's layer lies on the stage's sub-mesh, which has no pp)."""
    return dict(zip(p.device_mesh.mesh_dim_names, p.placements))


def param_spec(p: torch.Tensor) -> MeshSpecTuple:
    """:func:`spec_of` a DTensor ``p`` over its own mesh."""
    return spec_of(p.placements, p.device_mesh, p.ndim)


def region(shape: Sequence[int], spec: MeshSpecTuple,
           sizes: Mapping[str, int], coords: Mapping[str, int]
           ) -> Tuple[slice, ...]:
    """The region of a global tensor of ``shape`` that the rank at
    ``coords`` holds when dim *d* is sharded over the axes of
    ``spec[d]`` (``sizes``: every axis's size): per dim, the block of its
    axes' nested coordinates, outer first.  Needs no mesh (a checkpoint
    reassembles shards with it)."""
    index = [0] * len(shape)
    count = [1] * len(shape)
    for d, entry in enumerate(spec):
        for name in _axes(entry):
            index[d] = index[d] * sizes[name] + coords[name]
            count[d] *= sizes[name]
    out = []
    for d, n in enumerate(shape):
        if n % count[d]:
            raise ValueError(f"dim {d} of size {n} is not divisible by "
                             f"{count[d]} shards")
        per = n // count[d]
        out.append(slice(index[d] * per, (index[d] + 1) * per))
    return tuple(out)


def _factor(entry, sizes: Mapping[str, int]) -> int:
    return int(np.prod([sizes[a] for a in _axes(entry)]))


def q8_spec(shape: Sequence[int], spec: MeshSpecTuple,
            sizes: Mapping[str, int]) -> MeshSpecTuple:
    """The per-dim mesh axes of the int8 codes of a parameter of
    ``shape`` laid out by ``spec`` (the scales take the same: their last
    dim is 1 and never sharded) — JAX ``tree_shardings``' rule for its
    ``q8_codes``/``q8_scale`` leaves: the parameter's spec cut or padded
    to the codes' rank (a last-axis entry lands on the block-count dim),
    and any dim that the blocked shape cannot divide by its mesh factor
    replicated."""
    codes = blocked_shape(shape)
    parts = list(spec)[:len(codes)]
    parts += [None] * (len(codes) - len(parts))
    return tuple(None if codes[d] % _factor(e, sizes) else e
                 for d, e in enumerate(parts))


# the three ways a parameter's int8 blocks lie against its columns
ALIGNED = "aligned"          # a rank's blocks are its columns' blocks
REPLICATED = "replicated"    # every rank of the axis holds every block
UNALIGNED = "unaligned"      # blocks sharded, not on the columns' cut


@dataclasses.dataclass(frozen=True)
class Q8Layout:
    """Where one parameter's int8 moments lie on the mesh.

    ``shape``/``spec``: the global codes' shape and per-dim mesh axes
    (:func:`q8_spec`; the scales' shape ends in 1 instead of 256);
    ``region``: this rank's region of the global codes; ``groups``: the
    process groups of the mesh axes that cut the parameter's LAST axis,
    outer first; ``columns`` / ``blocks``: the
    global parameter columns / blocks of the last axis (the block-count
    dim) that this rank holds; ``case``: :data:`ALIGNED` (no axis cuts
    the last axis, or every shard is whole blocks), :data:`REPLICATED`
    (the blocks do not divide by the axes: each rank holds every block
    of its rows) or :data:`UNALIGNED` (the blocks are cut, but not
    where the columns are)."""

    case: str
    shape: Tuple[int, ...]
    spec: MeshSpecTuple
    region: Tuple[slice, ...]
    columns: slice
    blocks: slice
    groups: tuple = dataclasses.field(default=(), compare=False,
                                      repr=False)

    def field(self, name: str) -> Tuple[Tuple[int, ...], MeshSpecTuple,
                                         Tuple[slice, ...]]:
        """(global shape, spec, this rank's region) of the moment field
        ``name`` (``mu_codes``, ``mu_scales``, ...)."""
        if name.endswith("codes"):
            return self.shape, self.spec, self.region
        return ((*self.shape[:-1], 1), self.spec,
                (*self.region[:-1], slice(0, 1)))

    @property
    def local_shape(self) -> Tuple[int, ...]:
        """This rank's codes' shape."""
        return tuple(s.stop - s.start for s in self.region)


def q8_layout(shape: Sequence[int], spec: MeshSpecTuple,
              sizes: Mapping[str, int], coords: Mapping[str, int],
              groups: tuple = ()) -> Q8Layout:
    """The :class:`Q8Layout` of a parameter of ``shape`` laid out by
    ``spec`` at the rank of ``coords`` (``sizes``: every axis's size;
    ``groups``: the process groups of the last axis's mesh axes, for
    the update's gathers)."""
    shape = tuple(shape) or (1,)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    qspec = q8_spec(shape, spec, sizes)
    codes = blocked_shape(shape)
    reg = region(codes, qspec, sizes, coords)
    k = _factor(spec[-1], sizes)
    n = shape[-1]
    cols = region((n,), (spec[-1],), sizes, coords)[0]
    if k == 1 or n % (k * codes[-1]) == 0:
        case = ALIGNED
    elif qspec[-2] is None:
        case = REPLICATED
    else:
        case = UNALIGNED
    return Q8Layout(case=case, shape=codes, spec=qspec, region=reg,
                    columns=cols, blocks=reg[-2], groups=tuple(groups))


def param_q8_layout(p: torch.Tensor) -> Q8Layout:
    """:func:`q8_layout` of DTensor parameter ``p`` over its own mesh
    (a pp stage's layer over the stage's sub-mesh) at this rank."""
    mesh = p.device_mesh
    spec = param_spec(p)
    axes = _axes(spec[-1]) if spec else ()
    return q8_layout(p.shape, spec, mesh_axis_sizes(mesh), coordinates(mesh),
                     tuple(mesh.get_group(a) for a in axes))


def local_slices(shape: Sequence[int], mesh: DeviceMesh,
                 pl: Sequence[Placement],
                 coords: Optional[Mapping[str, int]] = None
                 ) -> Tuple[slice, ...]:
    """:func:`region` of the rank at ``coords`` (default: this rank)
    under the placements ``pl``."""
    return region(shape, spec_of(pl, mesh, len(shape)),
                  mesh_axis_sizes(mesh),
                  coordinates(mesh) if coords is None else coords)


def shard_tensor(full: torch.Tensor, mesh: DeviceMesh,
                 pl: Sequence[Placement]) -> DTensor:
    """A DTensor over ``mesh`` whose local tensor is this rank's region
    of ``full`` (every rank holds ``full``: nothing is communicated)."""
    local = full[local_slices(full.shape, mesh, pl)].contiguous()
    if local.data_ptr() == full.data_ptr():
        local = local.clone()
    return DTensor.from_local(local, mesh, tuple(pl), run_check=False,
                              shape=full.shape, stride=full.stride())


def data_block(mesh: DeviceMesh) -> Tuple[int, int]:
    """(index, count) of this rank's row block of a global batch: the
    batch is sharded over (dp, fsdp) and replicated over every other
    axis, so ranks that differ only off the data axes share a block."""
    return data_block_at(mesh_axis_sizes(mesh), coordinates(mesh))


def data_block_at(sizes: Mapping[str, int], coords: Mapping[str, int]
                  ) -> Tuple[int, int]:
    """:func:`data_block` of the rank at ``coords`` of a mesh of axis
    sizes ``sizes`` (needs no mesh)."""
    index, count = 0, 1
    for a in ("dp", "fsdp"):
        index = index * sizes[a] + coords[a]
        count *= sizes[a]
    return index, count


def local_batch(batch: Mapping[str, Any], mesh: DeviceMesh,
                device) -> Dict[str, DTensor]:
    """This rank's rows of a batch as DTensors with the batch's
    placements: ``batch`` holds the rows of this rank's block
    (:func:`data_block`), numpy arrays or tensors."""
    pl = batch_sharding(mesh)
    _, count = data_block(mesh)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        shape = [t.shape[0] * count, *t.shape[1:]]
        t = t.contiguous().to(device)
        out[k] = DTensor.from_local(
            t, mesh, pl, run_check=False, shape=tuple(shape),
            stride=torch.empty(shape, device="meta").stride())
    return out


def shard_batch(batch: Mapping[str, Any], mesh: DeviceMesh,
                device) -> Dict[str, DTensor]:
    """A GLOBAL batch (every rank holds all of it) as DTensors: each rank
    keeps its block's rows (:func:`data_block`)."""
    index, count = data_block(mesh)
    rows = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % count:
            raise ValueError(f"global batch {n} of {k!r} is not divisible "
                             f"by the {count} data blocks of the mesh")
        per = n // count
        rows[k] = v[index * per:(index + 1) * per]
    return local_batch(rows, mesh, device)


def to_local(t):
    """The local tensor of a DTensor; any other tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


# ---------------------------------------------------------------------------
# Serving tensor parallelism
# ---------------------------------------------------------------------------


def kv_cache_sharding(n_kv_heads: int, mesh) -> Tuple[int, int]:
    """The kv heads ``[lo, hi)`` this rank's serving KV cache holds (the
    contiguous ring, the paged pool, its int8 scales and staging tails:
    their kv-head axis, JAX's ``kv_cache_sharding``): its block of the
    ``tp`` axis, so every cache shard lives with the wk/wv columns that
    fill it; all of them when ``tp`` does not divide ``n_kv_heads`` (the
    cache is whole on every rank, as JAX's ``alloc_kv_buffer`` leaves
    it replicated)."""
    sizes = _sizes(mesh) or {}
    tp = sizes.get("tp", 1)
    if tp <= 1 or n_kv_heads % tp:
        return 0, n_kv_heads
    r = coordinates(mesh)["tp"]
    per = n_kv_heads // tp
    return r * per, (r + 1) * per


def serving_specs(shapes: Mapping[str, Any], mesh,
                  path_patterns: Sequence[Tuple[str, LogicalSpec]],
                  attn_split: bool = True
                  ) -> Dict[str, MeshSpecTuple]:
    """Every name of ``shapes`` (a state dict, or name -> shape) to its
    per-dim mesh axes on the serving mesh ``mesh`` (or its axis
    sizes): :func:`tree_specs` under :data:`SERVING_RULES` with every
    dim its mesh factor does not divide replicated (JAX's
    ``replicate_indivisible=True``).  A quantized projection's codes
    ``<name>.q`` take its kernel's spec, and its scales ``<name>.s``
    ``[1, out]`` the kernel's output-dim entry only: a column-parallel
    projection's scales are cut with its columns, a row-parallel one's
    stay whole (the scale is per output column, so it commutes with the
    sum over the rows' ranks).  ``attn_split=False`` keeps the
    attention projections whole."""
    sizes = _sizes(mesh)
    out = {}
    for name, t in shapes.items():
        shape = tuple(getattr(t, "shape", t))
        look = name
        if name.endswith((".q", ".s")):
            look = name[:-2] + ".kernel"
        logical = spec_for_path(path_patterns, look)
        if not attn_split and _ATTN.search(name):
            logical = ()
        pspec = list(logical_to_mesh(logical, SERVING_RULES, sizes))
        if name.endswith(".s"):
            pspec = [None] + pspec[1:2]
        pspec = pspec[:len(shape)]
        spec = tuple(pspec + [None] * (len(shape) - len(pspec)))
        out[name] = tuple(
            None if entry is not None and shape[d] % _factor(entry, sizes)
            else entry for d, entry in enumerate(spec))
    return out


def serving_region(shape: Sequence[int], spec: MeshSpecTuple,
                   mesh) -> Tuple[slice, ...]:
    """The region of a tensor of ``shape`` that this rank of the serving
    mesh holds under ``spec`` (:func:`serving_specs`): its
    :func:`local_slices`."""
    return local_slices(shape, mesh, placements(spec, mesh))
