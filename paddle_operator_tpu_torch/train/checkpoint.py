"""Checkpoint / resume — the port of ``paddle_operator_tpu/train/
checkpoint.py``.

The operator carries ``spec.checkpointPath`` into every pod as
``TPUJOB_CHECKPOINT_PATH``; a restarted gang comes back with the same
ranks and path, ``latest_step`` finds the newest complete checkpoint and
training resumes, and a serving pod boots from it.  The JAX package does
this through orbax, which imports jax, so the port writes torch's own
format:

- each step is a directory ``<path>/<step>/`` holding ``params.pt`` (the
  model's state dict, in the parameters' own dtype), ``opt.pt`` (``step``,
  the Adam ``count``, the ``moments`` kind and the state's tensors: f32
  ``mu`` and ``nu``, or under int8 moments ``mu_codes``, ``mu_scales``,
  ``nu_codes`` and ``nu_scales``) and, written last,
  ``torch_checkpoint.json`` (the format and the step).  A server reads
  ``params.pt`` alone, whatever ``opt.pt`` holds.  The files hold only
  tensors, ints, strings and plain dicts, and load with
  ``torch.load(weights_only=True, mmap=True)``;
- a step is committed by writing it into a temporary sibling directory
  (``.<step>.tmp-*``), flushing every file and the directory, and
  renaming it to ``<path>/<step>``.  Only committed steps are steps: a
  temporary directory that a killed writer left behind is not one;
- a directory ``<path>/<digits>`` without ``torch_checkpoint.json`` was
  not written by this package (an orbax checkpoint of the JAX package,
  say).  Every listing refuses the path with an error naming it: it is
  neither skipped in silence nor overwritten by a fresh start.

A state sharded over a mesh of more than one rank
(``train/trainer.py`` ``create_state(mesh=...)``) is saved in the same
step directory, so a server and a one-card trainer read it as they read
any step:

- ``params.pt`` is whole: every parameter is all-gathered
  (``parallel/collectives.py`` ``full_tensor``) and rank 0 writes the
  file.  Under pp rank 0 holds only stage 0's layers: each other
  stage's first rank sends its gathered layers to rank 0 over the
  mesh's gloo group (c10d ``send``/``recv`` of host copies), so every
  layer is saved once;
- the moments are written per rank, unreplicated: each rank at dp
  coordinate 0 writes ``opt-<rank>.pt`` (its coordinates, the mesh's
  axis sizes, and per field and name the local shard with the global
  shape and the per-dim mesh axes that cut it), holding each tensor
  that no other rank holds at a lower coordinate: a moment replicated
  over an axis is written once, by the rank at coordinate 0 of that
  axis (an f32 moment's shape and axes are its parameter's; int8 codes
  and scales are the rank's region of the GLOBAL blocks, with the
  blocked shape and JAX's q8 axes, ``parallel/sharding.py``
  ``Q8Layout``), and rank 0 writes ``opt.pt`` with ``step``,
  ``count``, ``moments`` and ``"sharded"`` (the axis sizes and the
  shard files) instead of the tensors;
- the ranks agree on the temporary directory, each writes its files
  there, and the step is committed in ``wait``: once every rank's
  writer is done, the ranks agree over the mesh's gloo group that none
  failed (a failure on any rank raises on every rank and leaves no
  step), rank 0 writes the marker and renames, and a barrier follows.

A restore into a sharded state cuts each rank's region out of
``params.pt``, and reads each moment from the shard file that holds its
region when the mesh has the saved axis sizes, else reassembles them
whole and cuts them (another mesh, or none: int8 codes and scales are
reassembled and recut as whole blocks, a concatenation, never a
requantization); a restore into a one-card state reassembles the
moments from the shard files.  A pp rank reads only its
stage's layers and the replicated parameters.  So a step restores on
its mesh bit for bit, on one card, on another mesh, and in the server.

Saves are asynchronous.  ``save`` copies the state to host memory before
it returns — the train step updates parameters and moments IN PLACE, so
a writer that read the live tensors would write a later step's numbers —
and one background thread writes the copy.  ``wait`` joins it and raises
what it raised.  Moments offloaded to host memory
(``train/trainer.py`` ``MomentOffload``) are copied back by the card
asynchronously: the snapshot and a restore first wait for the last of
those copies, and a restore writes into the pinned host tensors in
place.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from paddle_operator_tpu_torch.parallel import mesh as M
from paddle_operator_tpu_torch.parallel.sharding import (local_slices,
                                                         param_spec, region,
                                                         to_local)

FORMAT = 1
PARAMS_FILE = "params.pt"
OPT_FILE = "opt.pt"
MARKER = "torch_checkpoint.json"
SHARD_FILE = "opt-{rank}.pt"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_file(path: str, obj: Any) -> None:
    with open(path, "wb") as f:
        if isinstance(obj, bytes):
            f.write(obj)
        else:
            torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())


def _load(path: str) -> Any:
    return torch.load(path, weights_only=True, map_location="cpu",
                      mmap=True)


def _check_like(saved: Dict[str, torch.Tensor], like: Dict[str, Any],
                what: str, where: str) -> None:
    """Raise unless ``saved`` has exactly ``like``'s keys and shapes."""
    missing = sorted(set(like) - set(saved))
    unexpected = sorted(set(saved) - set(like))
    if missing or unexpected:
        raise ValueError(f"{where}: {what} do not match the model: missing "
                         f"{missing}, unexpected {unexpected}")
    bad = [f"{k} {tuple(saved[k].shape)} != {tuple(like[k].shape)}"
           for k in sorted(like) if saved[k].shape != like[k].shape]
    if bad:
        raise ValueError(f"{where}: {what} shapes differ: {bad}")


class _Shard:
    """A moment shard read from its file: compares as its global shape
    (``_check_like``); ``local`` is the tensor."""

    def __init__(self, entry: dict) -> None:
        self.shape = torch.Size(entry["shape"])
        self.local = entry["local"]
        self.dtype = self.local.dtype


def _cut(p, mesh) -> tuple:
    """The region of parameter ``p``'s global tensor that this rank
    holds (all of it on one card or a mesh of one rank); a stage's
    layer is cut over the stage's sub-mesh it lies on."""
    if M.is_trivial(mesh):
        return tuple(slice(None) for _ in p.shape)
    return local_slices(p.shape, p.device_mesh, p.placements)


def _spec_axes(spec) -> set:
    return {a for entry in spec if entry is not None
            for a in ((entry,) if isinstance(entry, str) else entry)}


def _moment_layout(opt, field: str, name: str, p, mesh) -> tuple:
    """(global shape, per-dim mesh axes, this rank's region) of moment
    ``field`` of parameter ``name`` (``p``, a DTensor) in a state on
    ``mesh``: an f32 moment's are its parameter's, int8 codes' and
    scales' their ``Q8Layout``'s."""
    layout = getattr(opt, "layout", None)
    if layout:
        return layout[name].field(field)
    return tuple(p.shape), param_spec(p), _cut(p, mesh)


def _holder(p, spec, coords) -> tuple:
    """The coordinates of the rank that writes this rank's region of a
    tensor cut by ``spec`` over the mesh that parameter ``p`` lies on:
    this rank's, with 0 on every axis of that mesh that does not cut the
    tensor (a pp stage's layer keeps its pp coordinate: its mesh has no
    pp)."""
    cut, own = _spec_axes(spec), set(p.device_mesh.mesh_dim_names)
    return {a: c if a in cut or a not in own else 0
            for a, c in coords.items()}


def _stage_view(saved: Dict[str, Any], model: nn.Module) -> Dict[str, Any]:
    """``saved`` without the layers that ``model`` leaves to other
    pipeline stages (``models.llama.OtherStage``); what is left must
    then match the model (``_check_like``)."""
    from paddle_operator_tpu_torch.models.llama import (OtherStage,
                                                        layer_index)

    others = {i for i, m in enumerate(getattr(model, "layers", ()))
              if isinstance(m, OtherStage)}
    if not others:
        return saved
    return {k: v for k, v in saved.items() if layer_index(k) not in others}


def _settle(opt_state) -> None:
    """Wait for the card's copies into an offloaded state's host
    tensors (none for a resident state)."""
    if getattr(opt_state, "offload", None) is not None:
        opt_state.offload.wait()


def _stage_leader(mesh, stage: int) -> int:
    """The rank that sends pp stage ``stage``'s layers to rank 0: the
    stage's rank at every other coordinate 0."""
    return int(mesh.mesh[tuple(stage if a == "pp" else 0
                               for a in mesh.mesh_dim_names)])


def _gather_stages(params: Dict[str, torch.Tensor], mesh, ctrl) -> None:
    """Under pp, bring every stage's gathered layers (host copies; its
    leader holds them) to rank 0 in ``params``, in order over the gloo
    group ``ctrl``: each leader sends its layers, rank 0 receives them
    into tensors shaped as its own stage's layer at the same place in
    the block.  Other ranks drop what they gathered."""
    from paddle_operator_tpu_torch.models.llama import layer_index

    pp = M.mesh_axis_sizes(mesh)["pp"]
    if pp <= 1:
        return
    rank = dist.get_rank()
    mine = [k for k in params if layer_index(k) is not None]
    per = len({layer_index(k) for k in mine})
    for stage in range(1, pp):
        src = _stage_leader(mesh, stage)
        if rank == src:
            for k in mine:
                dist.send(params[k], dst=0, group=ctrl)
        elif rank == 0:
            for k in mine:
                i = layer_index(k)
                name = f"layers.{i + stage * per}." \
                    + k[len(f"layers.{i}."):]
                params[name] = torch.empty_like(params[k])
                dist.recv(params[name], src=src, group=ctrl)
    if rank != 0:
        params.clear()


class CheckpointManager:
    """Save and restore a :class:`train.trainer.TrainState` under
    ``path`` (default ``$TPUJOB_CHECKPOINT_PATH``; no path, disabled).

    ``save_interval_steps`` is orbax's default policy: an unforced save
    of ``step`` happens when ``step % save_interval_steps == 0`` and
    ``step`` is past every saved or pending step.  After each commit the
    oldest steps beyond ``max_to_keep`` are deleted.  ``last_save`` holds
    the newest save's ``step``, ``bytes`` on disk, ``snapshot_s`` (the
    copy to host memory: how long ``save`` held the caller) and
    ``write_s`` (the background write); its last two keys appear once
    the write has committed."""

    def __init__(self, path: Optional[str] = None, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1000) -> None:
        self.path = path or os.environ.get("TPUJOB_CHECKPOINT_PATH", "")
        if max_to_keep < 1 or save_interval_steps < 1:
            raise ValueError(f"max_to_keep {max_to_keep} and "
                             f"save_interval_steps {save_interval_steps} "
                             "must be at least 1")
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.last_save: Dict[str, float] = {}
        self._thread: Optional[threading.Thread] = None
        self._pending: Optional[int] = None
        self._error: Optional[BaseException] = None
        # a sharded save waiting for its commit: (step, tmp dir, mesh)
        self._commit: Optional[tuple] = None

    @property
    def enabled(self) -> bool:
        return bool(self.path)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.path, str(step))

    def all_steps(self) -> list:
        """Committed steps, ascending (the restore fallback walks this
        backwards when the newest step turns out corrupt).  Raises
        ``ValueError`` on a step directory this package did not
        write."""
        if not self.enabled or not os.path.isdir(self.path):
            return []
        steps = []
        for name in os.listdir(self.path):
            d = os.path.join(self.path, name)
            if not (name.isascii() and name.isdigit() and os.path.isdir(d)):
                continue          # temporary directories, other files
            if not os.path.exists(os.path.join(d, MARKER)):
                raise ValueError(
                    f"{d} is a checkpoint step that paddle_operator_tpu_torch"
                    f" did not write (no {MARKER}; an orbax checkpoint of "
                    "the JAX package?): the torch package neither reads "
                    "nor replaces it; give it a checkpoint path of its own")
            steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        """The unforced policy (class docstring).  The directory is
        listed only on the interval's steps."""
        if step % self.save_interval_steps:
            return False
        known = self.all_steps()
        if self._pending is not None:
            known.append(self._pending)
        return not known or max(known) < step

    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        """Save ``state`` (a TrainState) as ``step`` in the background.
        Returns True when a save was scheduled.  A write still in flight
        is waited for first; a step already committed raises
        ``ValueError``."""
        if not self.enabled or not (force or self.should_save(step)):
            return False
        self.wait()
        if step in self.all_steps():
            raise ValueError(f"checkpoint step {step} already exists under "
                             f"{self.path}")
        t0 = time.perf_counter()
        opt = state.opt_state
        _settle(opt)
        mesh = getattr(state, "mesh", None)
        if not M.is_trivial(mesh):
            self._save_sharded(step, state, mesh, t0)
            return True
        # copy=True: on the CPU .to("cpu") would hand back the live
        # tensor itself
        params = {k: to_local(v).detach().to("cpu", copy=True)
                  for k, v in state.model.state_dict().items()}
        rest = {"step": int(state.step), "count": int(opt.count),
                "moments": opt.kind,
                **{field: {k: v.detach().to("cpu", copy=True)
                           for k, v in tensors.items()}
                   for field, tensors in opt.tensors().items()}}
        self.last_save = {"step": step,
                          "snapshot_s": time.perf_counter() - t0}
        self._pending = step
        self._thread = threading.Thread(
            target=self._write, args=(step, params, rest),
            name=f"checkpoint-{step}")
        self._thread.start()
        return True

    def _save_sharded(self, step: int, state: Any, mesh, t0: float) -> None:
        """The snapshot of a sharded state (module docstring): the whole
        parameters on rank 0, this rank's moment shards if it is a
        writer; one background thread a rank writes its files."""
        from paddle_operator_tpu_torch.parallel.collectives import (
            full_tensor)

        rank = dist.get_rank()
        ctrl = M.control_group(mesh)
        tmp = [f".{step}.tmp-{uuid.uuid4().hex[:12]}" if rank == 0 else None]
        dist.broadcast_object_list(tmp, src=0, group=ctrl)
        tmp = os.path.join(self.path, tmp[0])
        files: Dict[str, Any] = {}
        params = {}
        leader = _stage_leader(mesh, M.coordinates(mesh)["pp"])
        for k, v in state.model.state_dict().items():
            full = full_tensor(v)
            if rank == leader:        # rank 0 leads stage 0
                params[k] = full.detach().to("cpu", copy=True)
            del full
        _gather_stages(params, mesh, ctrl)
        opt = state.opt_state
        writers = [int(r) for r in mesh.mesh[0].flatten()]
        sizes, coords = M.mesh_axis_sizes(mesh), M.coordinates(mesh)
        if rank == 0:
            files[PARAMS_FILE] = params
            files[OPT_FILE] = {
                "step": int(state.step), "count": int(opt.count),
                "moments": opt.kind,
                "sharded": {"mesh": sizes,
                            "files": [SHARD_FILE.format(rank=r)
                                      for r in writers]}}
        if rank in writers:
            named = dict(state.model.named_parameters())
            shard: Dict[str, Any] = {"coords": coords, "mesh": sizes}
            for field, tensors in opt.tensors().items():
                shard[field] = {}
                for k, t in tensors.items():
                    shape, spec, _ = _moment_layout(opt, field, k,
                                                    named[k], mesh)
                    if _holder(named[k], spec, coords) == coords:
                        shard[field][k] = {
                            "local": t.detach().to("cpu", copy=True),
                            "shape": tuple(shape), "spec": spec}
            files[SHARD_FILE.format(rank=rank)] = shard
        self.last_save = {"step": step,
                          "snapshot_s": time.perf_counter() - t0}
        self._pending = step
        self._commit = (step, tmp, mesh, time.perf_counter())
        self._thread = threading.Thread(
            target=self._write_files, args=(tmp, files),
            name=f"checkpoint-{step}")
        self._thread.start()

    def _write_files(self, tmp: str, files: Dict[str, Any]) -> None:
        try:
            os.makedirs(tmp, exist_ok=True)
            for name, obj in files.items():
                _write_file(os.path.join(tmp, name), obj)
        except BaseException as err:   # raised by wait(), on every rank
            self._error = err

    def _commit_sharded(self, commit: tuple,
                        err: Optional[BaseException]
                        ) -> Optional[BaseException]:
        """Commit a sharded step once every rank's files are written:
        the ranks agree that none failed, rank 0 writes the marker and
        renames, and a second agreement is the barrier.  Returns the
        error to raise (this rank's, or one naming a peer's failure)."""
        step, tmp, mesh, t0 = commit
        ctrl = M.control_group(mesh)
        ok = torch.tensor([int(err is None)], dtype=torch.int32)
        dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=ctrl)
        failed: Optional[BaseException] = None
        if dist.get_rank() == 0:
            try:
                if not ok.item():
                    shutil.rmtree(tmp, ignore_errors=True)
                else:
                    _write_file(os.path.join(tmp, MARKER), json.dumps(
                        {"format": FORMAT, "step": step}).encode())
                    _fsync_dir(tmp)
                    nbytes = sum(os.path.getsize(os.path.join(tmp, f))
                                 for f in os.listdir(tmp))
                    os.rename(tmp, self._step_dir(step))
                    _fsync_dir(self.path)
                    self.last_save["bytes"] = nbytes
                    self._drop_old()
            except BaseException as e:
                failed = e
                shutil.rmtree(tmp, ignore_errors=True)
        done = torch.tensor([int(failed is None)], dtype=torch.int32)
        dist.all_reduce(done, op=dist.ReduceOp.MIN, group=ctrl)
        self.last_save["write_s"] = time.perf_counter() - t0
        if err is not None or failed is not None:
            return err or failed
        if not ok.item() or not done.item():
            return RuntimeError(f"checkpoint step {step}: another rank's "
                                "part failed; the step was not committed")
        return None

    def _drop_old(self) -> None:
        for old in self.all_steps()[:-self.max_to_keep]:
            # renamed out of the step namespace first: a kill mid-delete
            # leaves a temporary directory, not a torn step
            doomed = os.path.join(
                self.path, f".{old}.tmp-{uuid.uuid4().hex[:12]}")
            os.rename(self._step_dir(old), doomed)
            shutil.rmtree(doomed)

    def _write(self, step: int, params: dict, rest: dict) -> None:
        try:
            t0 = time.perf_counter()
            os.makedirs(self.path, exist_ok=True)
            tmp = os.path.join(self.path,
                               f".{step}.tmp-{uuid.uuid4().hex[:12]}")
            os.mkdir(tmp)
            try:
                _write_file(os.path.join(tmp, PARAMS_FILE), params)
                _write_file(os.path.join(tmp, OPT_FILE), rest)
                _write_file(os.path.join(tmp, MARKER), json.dumps(
                    {"format": FORMAT, "step": step}).encode())
                _fsync_dir(tmp)
                nbytes = sum(os.path.getsize(os.path.join(tmp, f))
                             for f in (PARAMS_FILE, OPT_FILE, MARKER))
                os.rename(tmp, self._step_dir(step))
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            _fsync_dir(self.path)
            self.last_save.update(bytes=nbytes,
                                  write_s=time.perf_counter() - t0)
            self._drop_old()
        except BaseException as err:   # raised by wait()
            self._error = err

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """Load ``step`` (default: the newest) into ``state_like`` in place
        and return it.  ``state_like`` is a TrainState — parameters
        (through ``load_state_dict``, which keeps the ``Parameter``
        objects the optimizer state is keyed by), the moments (on their
        parameters' devices, in their saved dtypes; into the host
        tensors of an offloaded state), ``count`` and ``step`` — or a
        model, whose parameters alone are loaded, cast to the model's own
        dtypes (the serving restore: ``opt.pt`` is not read).  A missing
        or unexpected key, a shape mismatch or moments of another kind
        (f32 or int8) raise before anything is changed.  A state on a
        mesh gets its ranks' regions (module docstring)."""
        if not self.enabled:
            raise RuntimeError("checkpointing disabled (no path)")
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.path}")
        d = self._step_dir(step)
        with open(os.path.join(d, MARKER)) as f:
            meta = json.load(f)
        if meta != {"format": FORMAT, "step": step}:
            raise ValueError(f"{d}: unexpected {MARKER} {meta}")
        model = state_like if isinstance(state_like, nn.Module) \
            else state_like.model
        params = _stage_view(_load(os.path.join(d, PARAMS_FILE)), model)
        _check_like(params, model.state_dict(), "parameters", d)
        if isinstance(state_like, nn.Module):
            model.load_state_dict(params)
            return state_like
        rest = _load(os.path.join(d, OPT_FILE))
        opt = state_like.opt_state
        kind = rest.get("moments", "f32")      # PR 9's files say nothing
        if kind != opt.kind:
            raise ValueError(f"{d}: {kind} moments, the state holds "
                             f"{opt.kind} moments")
        named = dict(model.named_parameters())
        mine = opt.tensors()
        mesh = getattr(state_like, "mesh", None)
        layouts = {} if M.is_trivial(mesh) else {
            f: {k: _moment_layout(opt, f, k, p, mesh)
                for k, p in named.items()} for f in opt.FIELDS}
        moments, cut = self._moments(d, rest, opt.FIELDS, mesh, named,
                                     layouts)
        moments = {f: _stage_view(v, model) for f, v in moments.items()}
        for field in opt.FIELDS:
            # a sharded state's moments have their global shapes
            like = mine[field] if M.is_trivial(mesh) else {
                k: torch.empty(shape, device="meta")
                for k, (shape, _, _) in layouts[field].items()}
            _check_like(moments[field], like, f"moments {field!r}", d)
            if opt.offload is not None:
                bad = sorted(k for k, v in moments[field].items()
                             if v.dtype != mine[field][k].dtype)
                if bad:
                    raise ValueError(f"{d}: moments {field!r} of {bad} are "
                                     "not in the offloaded state's dtype")
        _settle(opt)
        if mesh is None:
            model.load_state_dict(params)
        else:
            with torch.no_grad():
                for k, p in named.items():
                    to_local(p).copy_(params[k][_cut(p, mesh)])
        for field in opt.FIELDS:
            for k, v in moments[field].items():
                if cut:
                    v = v[layouts[field][k][2]]
                if isinstance(v, _Shard):
                    v = v.local
                if opt.offload is not None:
                    # into the pinned host tensors the offload streams
                    mine[field][k].copy_(v)
                else:
                    # copy=True: nothing stays backed by the mapped file
                    opt.replace(field, k, v.to(to_local(named[k]).device,
                                               copy=True).contiguous())
        opt.count = int(rest["count"])
        state_like.step = int(rest["step"])
        return state_like

    def _moments(self, d: str, rest: dict, fields, mesh, named,
                 layouts) -> tuple:
        """(field -> name -> tensor, whether each tensor is whole and must
        be cut to this rank's region).  A sharded step restored on a mesh
        of its axis sizes reads each region from the shard file of the
        rank that wrote it (:func:`_holder`; the files are
        memory-mapped, so the rest of a file is never read; shapes are
        checked as the global ones); otherwise the moments are whole:
        ``opt.pt``'s, or reassembled from the shard files."""
        sharded = rest.get("sharded")
        if sharded is None:
            return {f: rest[f] for f in fields}, not M.is_trivial(mesh)
        if not M.is_trivial(mesh) \
                and sharded["mesh"] == M.mesh_axis_sizes(mesh):
            coords = M.coordinates(mesh)
            out: Dict[str, Dict[str, Any]] = {f: {} for f in fields}
            files: Dict[int, Any] = {}
            for f in fields:
                for k, (_, spec, _) in layouts[f].items():
                    at = _holder(named[k], spec, coords)
                    writer = int(mesh.mesh[tuple(
                        at[a] for a in mesh.mesh_dim_names)])
                    if writer not in files:
                        files[writer] = _load(os.path.join(
                            d, SHARD_FILE.format(rank=writer)))
                    entry = files[writer][f].get(k)
                    if entry is not None:
                        out[f][k] = _Shard(entry)
            return out, False
        whole: Dict[str, Dict[str, torch.Tensor]] = {f: {} for f in fields}
        for name in sharded["files"]:
            shard = _load(os.path.join(d, name))
            for f in fields:
                for k, e in shard[f].items():
                    full = whole[f].get(k)
                    if full is None:
                        full = whole[f][k] = torch.empty(
                            e["shape"], dtype=e["local"].dtype)
                    full[region(e["shape"], e["spec"], shard["mesh"],
                                shard["coords"])] = e["local"]
        return whole, not M.is_trivial(mesh)

    def wait(self) -> None:
        """Block until the pending save is durable; raise what its
        writer raised."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        self._pending = None
        err, self._error = self._error, None
        commit, self._commit = self._commit, None
        if commit is not None:
            err = self._commit_sharded(commit, err)
        if err is not None:
            raise err

    def close(self) -> None:
        """Flush the pending save (an exiting trainer that saved and
        closed must not drop its newest checkpoint: the step a
        preemption drain forced)."""
        self.wait()


def resume_or_init(ckpt: CheckpointManager, init_fn, state_like=None, *,
                   logger=None):
    """The restart-recovery entry: restore the latest checkpoint if one
    exists, else initialize fresh.  ``init_fn()`` builds a fresh state
    (or model); ``state_like`` (default: ``init_fn()``) is what the
    checkpoint is restored into.  Returns ``(state, resumed)``.

    A corrupt or partial newest step (a torn write during the kill that
    caused this very restart) falls back to the previous complete step
    with a logged warning; only when every step fails does the newest
    step's error surface."""
    if ckpt.enabled and ckpt.latest_step() is not None:
        if logger is None:
            # the fallback is never silent, even for callers that pass
            # no logger
            from paddle_operator_tpu_torch.utils.observability import (
                get_logger)

            logger = get_logger()
        like = state_like if state_like is not None else init_fn()
        first_err: Optional[Exception] = None
        for step in reversed(ckpt.all_steps()):
            try:
                return ckpt.restore(like, step=step), True
            except Exception as err:
                if first_err is None:
                    first_err = err
                logger.warning(
                    f"checkpoint step {step} failed to restore "
                    f"({type(err).__name__}: {err}); trying the "
                    f"previous complete step")
        raise first_err
    return init_fn(), False
