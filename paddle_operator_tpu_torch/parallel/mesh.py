"""Device-mesh construction — the port of
``paddle_operator_tpu/parallel/mesh.py``.

The ``TPUJob`` CRD carries logical axes (``api.types.MeshSpec``); every
process of the job builds the same
``torch.distributed.device_mesh.DeviceMesh`` over the process group
that ``launch/launcher.py`` ``initialize`` set up, one rank a card, its
dimensions named as the JAX package names them (outermost → innermost):

    dp    pure data parallel — gradient all-reduce only (across slices);
    pp    pipeline stages;
    fsdp  fully-sharded data parallel — params and moments sharded,
          gathered a layer at a time, gradients reduce-scattered;
    cp    context (sequence) parallel;
    ep    expert parallel;
    tp    tensor parallel — activations all-reduced every layer, the
          chattiest axis, so innermost.

What differs from the JAX module:

- ``make_mesh`` takes the card type (``device`` "cuda", the default:
  nccl groups; "cpu": gloo groups, the tests) instead of a device list
  (a gloo group carries CUDA tensors too: phase 3s (b) of chip_smoke.py
  puts two ranks on one card through it, which nccl refuses);
  rank *r* of the process group sits at flat position *r* of the mesh
  (the JAX package's reshape of the device list).  A pod of several
  cards runs one rank a card, numbered pod-major (``launch/launcher.py``
  ``initialize``: pod × cards + ``LOCAL_RANK``), so the layout is JAX's
  mesh over its devices ordered by (process, local id), and a pod's
  cards take the innermost coordinates (tp first).  The axis product
  must equal the world size (the same ``ValueError``).  With no process
  group initialized, a mesh of size 1 builds a world-1 group over an
  in-process store (``torch.distributed.HashStore``): a one-worker job
  needs no coordinator and no ``MASTER_ADDR``.
- :func:`make_serving_mesh` is a one-axis ``("tp",)`` DeviceMesh over a
  world of exactly ``tp`` ranks, one process a card (the JAX mesh's
  ``tp`` devices driven by one process), over the backend the caller's
  process group runs: nccl on cards, gloo on the CPU or on ranks that
  share a card.  Its control group (:func:`control_group`) carries the
  serving ring's host messages (``infer/tp.py``) and never times out
  while a follower waits for the leader.  ``resolve_shard_map_mesh``,
  ``supports_partial_manual`` and ``compat_shard_map`` are JAX-version
  shims with no counterpart.
- Every axis runs: ``cp`` (ring and Ulysses attention), ``pp`` (the
  GPipe and 1F1B pipeline step) and ``ep`` (the MoE layer's local
  experts, ``models/moe.py``); the ``ep`` group of a rank is
  ``axis_group(mesh, "ep")``, inside its pp stage's sub-mesh under pp.
- Under ``pp`` a stage's layers live only on that stage's ranks: their
  DTensors are laid over :func:`stage_mesh`, the mesh without ``pp`` at
  this rank's stage (:data:`STAGE_AXES`).
- A mesh over more than one rank carries a gloo group over the same
  ranks (:func:`control_group`) for host-side agreement (the drain
  flag, the checkpoint commit): it never waits for the card.
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from paddle_operator_tpu_torch.api.types import MeshSpec

# outermost → innermost (see module docstring)
AXIS_ORDER: Sequence[str] = ("dp", "pp", "fsdp", "cp", "ep", "tp")

# Axes over which a batch is split (data axes): batch sharding and gradient
# reduction happen over these.
DATA_AXES = ("dp", "fsdp")

# Axes over which the tokens of a global batch are split: a loss's
# denominator and every gradient are summed over these.
TOKEN_AXES = DATA_AXES + ("cp",)

# The axes of a pipeline stage's sub-mesh (every axis but pp).
STAGE_AXES: Sequence[str] = tuple(a for a in AXIS_ORDER if a != "pp")

# mesh -> its host-side gloo group (meshes over the same ranks compare
# equal and share one)
_CONTROL: Dict[DeviceMesh, Optional[dist.ProcessGroup]] = {}
# mesh -> the sub-mesh of this rank's pipeline stage
_STAGE: Dict[DeviceMesh, DeviceMesh] = {}


def mesh_shape(spec: MeshSpec) -> List[int]:
    return [getattr(spec, a) for a in AXIS_ORDER]


def _backend(device) -> Tuple[str, str]:
    """(device type, backend) for ``device``: nccl on the card, gloo
    on the CPU.  No card on a "cuda" request raises."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA card for an nccl mesh; "
                               "pass device='cpu' for a gloo mesh")
        return kind, "nccl"
    if kind == "cpu":
        return kind, "gloo"
    raise ValueError(f"make_mesh: device {device!r} (expected 'cuda' or "
                     "'cpu')")


def init_world_of_one(device="cuda") -> None:
    """A world-1 process group over an in-process store, unless one is
    initialized: the group a one-worker job's mesh is built over."""
    if dist.is_initialized():
        return
    _, backend = _backend(device)
    dist.init_process_group(backend, store=dist.HashStore(), world_size=1,
                            rank=0)


def rank_grid(spec: Optional[MeshSpec] = None) -> torch.Tensor:
    """The ranks of ``spec``'s mesh laid over its axes: rank *r* at flat
    position *r* (needs no process group)."""
    shape = mesh_shape(spec or MeshSpec())
    return torch.arange(int(torch.tensor(shape).prod())).reshape(shape)


def make_mesh(spec: Optional[MeshSpec] = None, *,
              device="cuda") -> DeviceMesh:
    """The job's DeviceMesh for ``spec`` over every rank of the process
    group, dimensions named by :data:`AXIS_ORDER` (size-1 axes
    included, as in the JAX mesh).

    The axis product must equal the world size (validated — the
    CRD-side twin of this check is TPUJob.validate()).  Every rank must
    call this in the same order as its other group creations."""
    spec = spec or MeshSpec()
    shape = mesh_shape(spec)
    size = 1
    for n in shape:
        size *= n
    world = dist.get_world_size() if dist.is_initialized() else 1
    if size != world:
        raise ValueError(
            f"mesh {dict(zip(AXIS_ORDER, shape))} needs {size} devices, "
            f"have {world}"
        )
    kind, backend = _backend(device)
    init_world_of_one(device)
    have = dist.get_backend()
    if have not in (backend, "gloo"):
        raise ValueError(f"make_mesh: a {kind} mesh needs the {backend} "
                         f"or gloo backend; the process group is {have}")
    if kind == "cuda":
        # one card a process: the current card (set before the groups'
        # communicators are made)
        torch.cuda.set_device(torch.cuda.current_device())
    mesh = DeviceMesh(kind, rank_grid(spec),
                      mesh_dim_names=tuple(AXIS_ORDER))
    # a host-side group over the same ranks (created by every rank here,
    # right after the mesh's own groups)
    _CONTROL[mesh] = dist.new_group(backend="gloo") if world > 1 else None
    return mesh


# a serving follower waits on the control group for as long as its
# leader idles between requests
_SERVING_CONTROL_TIMEOUT = datetime.timedelta(days=365)


def make_serving_mesh(tp: int, *, device="cuda") -> DeviceMesh:
    """The serving path's one-axis ``("tp",)`` mesh (JAX
    ``make_serving_mesh``): tensor parallelism over heads, ffn and vocab,
    the Megatron recipe, over every rank of the process group — which
    must hold exactly ``tp`` ranks, rank *r* at tp coordinate *r*.

    ``device`` is the card type of the tensors ("cuda" or "cpu"); the
    process group's backend is the caller's (nccl on cards; gloo on the
    CPU, or on CUDA tensors of ranks that share a card, which nccl
    refuses).  A ``tp`` of 1 with no group builds a world-1 group over
    an in-process store.  Every rank calls this once, in the same order
    as its other group creations."""
    if tp < 1:
        raise ValueError(f"tp={tp} must be >= 1")
    kind, backend = _backend(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != tp:
        raise ValueError(f"make_serving_mesh: tp={tp} needs a process "
                         f"group of {tp} ranks, have {world}")
    init_world_of_one(device)
    have = dist.get_backend()
    if have not in (backend, "gloo"):
        raise ValueError(f"make_serving_mesh: a {kind} mesh needs the "
                         f"{backend} or gloo backend; the process group "
                         f"is {have}")
    if kind == "cuda":
        torch.cuda.set_device(torch.cuda.current_device())
    mesh = DeviceMesh(kind, torch.arange(tp), mesh_dim_names=("tp",))
    _CONTROL[mesh] = (dist.new_group(backend="gloo",
                                     timeout=_SERVING_CONTROL_TIMEOUT)
                      if tp > 1 else None)
    return mesh


def mesh_tp(mesh: Optional[DeviceMesh]) -> int:
    """Size of the mesh's ``tp`` axis, 1 for no mesh (JAX
    ``infer/decode.py`` ``mesh_tp``): the one axis serving shards
    over.  Anything but a DeviceMesh raises ``TypeError``."""
    if mesh is None:
        return 1
    require_mesh(mesh)
    return mesh_axis_sizes(mesh).get("tp", 1)


def single_device_mesh(device="cuda") -> DeviceMesh:
    """A 1-card mesh (all axes size 1) — lets the same mesh train step
    run unmodified on one device."""
    return make_mesh(MeshSpec(), device=device)


def mesh_axis_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_group(mesh: DeviceMesh, axis: str
               ) -> Optional[dist.ProcessGroup]:
    """The process group along ``axis`` through this rank, or None when
    the axis has size 1 (nothing to communicate)."""
    if mesh_axis_sizes(mesh)[axis] <= 1:
        return None
    return mesh.get_group(axis)


def coordinates(mesh: DeviceMesh) -> Dict[str, int]:
    """This rank's position on every axis."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def control_group(mesh: DeviceMesh) -> Optional[dist.ProcessGroup]:
    """The gloo group over the mesh's ranks (None for one rank)."""
    return _CONTROL.get(mesh)


def is_trivial(mesh: Optional[DeviceMesh]) -> bool:
    """No mesh, or every axis of size 1."""
    return mesh is None or mesh.mesh.numel() == 1


def require_mesh(mesh) -> None:
    """A ``mesh`` argument is None or a DeviceMesh (:func:`make_mesh`):
    anything else raises ``TypeError``."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh (parallel/mesh.py "
                        f"make_mesh), not {type(mesh).__name__}")


def stage_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The sub-mesh of this rank's pipeline stage: ``mesh`` without its
    ``pp`` axis, at this rank's pp coordinate (:data:`STAGE_AXES`).  A
    stage's layers are DTensors over it: replicated or sharded over the
    ranks that hold that stage and no others.  Every rank of ``mesh``
    calls this in the same order (the first call slices the mesh)."""
    sub = _STAGE.get(mesh)
    if sub is None:
        sub = _STAGE[mesh] = mesh[tuple(STAGE_AXES)]
    return sub
