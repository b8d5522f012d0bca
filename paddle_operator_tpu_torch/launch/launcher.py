"""In-pod launcher — the port of ``paddle_operator_tpu/launch/launcher.py``:
consume the env contract the operator injects (``controller/builders.py``
of the JAX package: the rendezvous ConfigMap and the pod's own env) and
bring up ``torch.distributed`` over it.

    env (TPUJOB_*, MEGASCALE_*, TPU_WORKER_ID)
      -> JobEnv.from_env()
      -> initialize()            # torch.distributed over the coordinator

Entry point inside a training pod's container::

    python -m paddle_operator_tpu_torch.launch.launcher -- python train.py ...
    # or, programmatically (in the child):
    from paddle_operator_tpu_torch.launch import launcher
    env = launcher.initialize()

What differs from the JAX module:

- One process a card.  A JAX pod is one process that sees its chips as
  local devices; a pod of the port runs one process a card.  A pod's
  card count is ``mesh.size() / num_workers`` from the ConfigMap
  (:func:`pod_cards`; a mesh that is not a multiple of the worker count
  is refused by name).  With one card :func:`main` execs the command
  (or supervises it under ``TPUJOB_DRAIN``) as before; with more, the
  shim starts one child a card with ``LOCAL_RANK`` and
  ``LOCAL_WORLD_SIZE`` (PyTorch's names) and supervises them all
  (:func:`run_pod`, ROADMAP.md Queue A item 8.4).  Rank *r* of the
  world is card ``r % cards`` of pod ``r // cards``: JAX's devices
  ordered by (process, local id), so ``parallel/mesh.py`` lays the
  mesh over the ranks as JAX lays it over its devices, and a pod's
  cards take the innermost coordinates.
- :func:`initialize` is ``torch.distributed.init_process_group`` (the
  coordinator address as a ``tcp://`` rendezvous, ``num_workers ×
  cards`` ranks, this card's global rank): backend ``nccl`` on the
  card, ``gloo`` only when the caller asks for the CPU.  No card and no
  CPU request raises; nothing falls back to gloo.  On the card it
  selects card ``LOCAL_RANK`` first, and refuses by name a pod that
  sees fewer cards than it needs: a pod never shares a card.
- :func:`job_mesh` builds ``parallel/mesh.py`` ``make_mesh(env.mesh)``,
  a DeviceMesh over the group :func:`initialize` set up (``device``
  "cuda": nccl; "cpu": gloo), whose size must be the world's.  A
  one-card, one-worker job, for which :func:`initialize` makes no
  group, gets a world-1 group over an in-process store: no
  coordinator, no ``MASTER_ADDR``.  Every axis of the ConfigMap's
  ``TPUJOB_MESH`` is accepted (dp, pp, fsdp, cp, ep, tp): the mesh step
  runs them all, and refuses by name only an MoE model with ``cp``
  above 1 (item 8.6).  After an elastic slice drop the operator
  rewrites ``TPUJOB_MESH`` with a smaller ``dp``
  (``controller/builders.py`` of the JAX package), and the gang that
  restarts builds that mesh and resumes into it (``ft/elastic.py``).
- A ``ps`` or ``heter`` pod with no command would run the JAX package's
  parameter or batch-preparation server, which the port does not have
  (ROADMAP.md Queue A item 9): :func:`main` names that item and exits
  non-zero instead of exiting 0 with nothing served.
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from paddle_operator_tpu_torch.api.types import COORDINATOR_PORT, MeshSpec

# main()'s exit code for a pod whose default program is not ported
EXIT_UNPORTED = 2
_PS_TODO = ("the {res} tier's default program (a {res} pod started with no "
            "command) is not ported to the torch package (ROADMAP.md Queue A "
            "item 9, 'PS / heter'); give the pod a command")
# how long a failed pod's other children get after SIGTERM before SIGKILL
SIBLING_GRACE_S = 5.0


@dataclass
class JobEnv:
    """Parsed view of the env contract one pod sees."""

    job_name: str = ""
    rank: int = 0                    # global rank, disjoint across roles
    role_rank: int = 0               # index within this pod's role
    res_type: str = "worker"         # worker | ps | heter
    worker_id: int = 0               # slice-local id (TPU_WORKER_ID)
    slice_id: int = 0                # MEGASCALE_SLICE_ID
    num_workers: int = 1
    workers_per_slice: int = 1
    num_slices: int = 1
    coordinator_address: str = ""
    worker_hosts: List[str] = field(default_factory=list)
    ps_endpoints: List[str] = field(default_factory=list)
    heter_endpoints: List[str] = field(default_factory=list)
    role: str = "TRAINER"
    port: int = COORDINATOR_PORT
    mesh: MeshSpec = field(default_factory=MeshSpec)
    topology: str = ""
    accelerator: str = ""
    checkpoint_path: str = ""
    max_restarts: int = 0

    @classmethod
    def from_env(cls, environ=None) -> "JobEnv":
        e = environ if environ is not None else os.environ
        mesh_json = e.get("TPUJOB_MESH", "")
        mesh = MeshSpec.from_dict(json.loads(mesh_json)) if mesh_json \
            else MeshSpec()

        def split(key: str) -> List[str]:
            return [s for s in e.get(key, "").split(",") if s]

        rank = int(e.get("TPUJOB_RANK", 0))
        role = e.get("TPUJOB_ROLE", e.get("TRAINING_ROLE", "TRAINER"))
        # env from a controller older than TPUJOB_RES_TYPE: a PSERVER
        # role is the ps tier (else a ps pod would count as a worker and
        # collide with a worker's rank); old heter pods say TRAINER and
        # cannot be told from workers
        res_type = e.get("TPUJOB_RES_TYPE") or (
            "ps" if role == "PSERVER" else "worker")
        return cls(
            job_name=e.get("TPUJOB_NAME", ""),
            rank=rank,
            role_rank=int(e.get("TPUJOB_ROLE_RANK", rank)),
            res_type=res_type,
            worker_id=int(e.get("TPU_WORKER_ID", 0)),
            slice_id=int(e.get("MEGASCALE_SLICE_ID", 0)),
            num_workers=int(e.get("TPUJOB_NUM_WORKERS", 1)),
            workers_per_slice=int(e.get("TPUJOB_WORKERS_PER_SLICE", 1) or 1),
            num_slices=int(e.get("TPUJOB_NUM_SLICES", 1) or 1),
            coordinator_address=e.get("TPUJOB_COORDINATOR_ADDRESS", ""),
            worker_hosts=split("TPUJOB_WORKER_HOSTS"),
            ps_endpoints=split("TPUJOB_PS_ENDPOINTS"),
            heter_endpoints=split("TPUJOB_HETER_ENDPOINTS"),
            role=role,
            port=int(e.get("TPUJOB_PORT", COORDINATOR_PORT)),
            mesh=mesh,
            topology=e.get("TPUJOB_TOPOLOGY", ""),
            accelerator=e.get("TPUJOB_ACCELERATOR", ""),
            checkpoint_path=e.get("TPUJOB_CHECKPOINT_PATH", ""),
            max_restarts=int(e.get("TPUJOB_MAX_RESTARTS", 0)),
        )

    @property
    def is_xla_worker(self) -> bool:
        """Whether this process joins the collective world: only
        ``worker`` pods do (the ps and heter tiers serve workers over
        their own endpoints).  Worker ranks are 0..num_workers-1 by
        construction, so ``rank`` is the process group rank.  The name
        is the JAX package's."""
        return self.res_type == "worker"

    def slice_local_hosts(self) -> List[str]:
        """The hostnames of this pod's slice (``TPU_WORKER_HOSTNAMES``),
        derived because the job-wide ConfigMap cannot carry per-slice
        values."""
        lo = self.slice_id * self.workers_per_slice
        return self.worker_hosts[lo:lo + self.workers_per_slice]


def _export_hosts(env: JobEnv) -> None:
    """Set ``TPU_WORKER_HOSTNAMES`` to the slice's hosts, unconditionally:
    the job contract outranks a default a base image may have set."""
    hosts = env.slice_local_hosts()
    if hosts:
        os.environ["TPU_WORKER_HOSTNAMES"] = ",".join(hosts)


def pod_cards(env: JobEnv) -> int:
    """The cards of each worker pod: ``mesh.size() / num_workers`` (the
    ConfigMap's ``TPUJOB_MESH`` spans ``workers × chips_per_worker``
    devices; a mesh no larger than the worker count is one card a pod).
    A larger mesh that is not a multiple of the worker count raises
    ``ValueError`` naming both."""
    size = env.mesh.size()
    if size <= env.num_workers:
        return 1
    if size % env.num_workers:
        raise ValueError(f"mesh {env.mesh.to_dict()} has {size} devices, "
                         f"not a multiple of the {env.num_workers} worker "
                         "pods: a pod's card count must be a whole number")
    return size // env.num_workers


def process_rank(env: JobEnv, local: int) -> Tuple[int, int]:
    """(rank, world size) of the process of card ``local`` of ``env``'s
    pod: ``num_workers × cards`` ranks numbered pod-major, so rank *r* is
    card ``r % cards`` of pod ``r // cards`` (JAX's devices ordered by
    process, then local id)."""
    cards = pod_cards(env)
    return env.rank * cards + local, env.num_workers * cards


def local_card() -> Tuple[int, int]:
    """(``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) of this process: the card
    it runs on within its pod and the pod's process count, as
    :func:`run_pod` sets them (0 and 1 when unset)."""
    return (int(os.environ.get("LOCAL_RANK", 0) or 0),
            int(os.environ.get("LOCAL_WORLD_SIZE", 1) or 1))


def _select_card(cards: int, local: int) -> None:
    """Make card ``local`` this process's current card; a process sees
    every card of its pod, and a pod that sees fewer than ``cards``
    cards is refused by name."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("initialize: no CUDA card for the nccl backend; "
                           "pass device='cpu' to rendezvous over gloo")
    seen = torch.cuda.device_count()
    if seen < cards:
        raise RuntimeError(
            f"initialize: the pod runs {cards} cards (one process a card) "
            f"but sees {seen} CUDA card(s): a pod never shares a card")
    torch.cuda.set_device(local)


def initialize(env: Optional[JobEnv] = None, *, force: bool = False,
               device="cuda") -> JobEnv:
    """``torch.distributed.init_process_group`` from the env contract:
    ``num_workers × cards`` ranks (:func:`pod_cards`), this process
    rank ``env.rank × cards + LOCAL_RANK``.

    A no-op for a pod outside the collective world (ps, heter), and for
    a one-card, one-worker job unless ``force``.  ``device`` "cuda" (the
    default) takes the ``nccl`` backend and card ``LOCAL_RANK``, and
    needs the pod's cards; "cpu" takes ``gloo`` (the tests).  No card on
    a "cuda" request raises.  A process of a multi-card pod that the
    shim did not start (no ``LOCAL_WORLD_SIZE`` of the card count) is
    refused by name: one process must not drive several cards."""
    env = env or JobEnv.from_env()
    if not env.is_xla_worker and not force:
        return env
    cards = pod_cards(env)
    local, local_world = local_card()
    if local_world != cards or not 0 <= local < cards:
        raise RuntimeError(
            f"initialize: the pod has {cards} card(s) and runs one process "
            f"a card, but this process is LOCAL_RANK {local} of "
            f"LOCAL_WORLD_SIZE {local_world}: start the command under "
            "python -m paddle_operator_tpu_torch.launch.launcher -- ...")
    rank, world = process_rank(env, local)
    if world > 1 or force:
        import torch
        import torch.distributed as dist

        kind = torch.device(device).type
        if kind == "cuda":
            _select_card(cards, local)
            backend = "nccl"
        elif kind == "cpu":
            backend = "gloo"
        else:
            raise ValueError(f"initialize: device {device!r} (expected "
                             "'cuda' or 'cpu')")
        dist.init_process_group(
            backend, init_method="tcp://" + env.coordinator_address,
            world_size=world, rank=rank)
        _export_hosts(env)
    return env


def job_mesh(env: Optional[JobEnv] = None, *, device="cuda"):
    """Build the job-wide DeviceMesh from the contract (all processes
    agree, by construction: the MeshSpec comes from the ConfigMap).  A
    multi-worker job must have called :func:`initialize` first."""
    import torch.distributed as dist

    from paddle_operator_tpu_torch.parallel.mesh import (init_world_of_one,
                                                         make_mesh)

    env = env or JobEnv.from_env()
    cards = pod_cards(env)
    world = env.num_workers * cards
    if not dist.is_initialized():
        if world > 1:
            raise RuntimeError(f"job_mesh: a job of {env.num_workers} "
                               f"worker(s) × {cards} card(s) needs "
                               "initialize() first")
        init_world_of_one(device)
    if dist.get_world_size() != world:
        raise ValueError(f"job_mesh: the process group has "
                         f"{dist.get_world_size()} ranks, the job "
                         f"{env.num_workers} workers × {cards} cards")
    return make_mesh(env.mesh, device=device)


def run_supervised(argv: List[str]) -> int:
    """Drain-aware child supervision (``TPUJOB_DRAIN=1``): run the command
    as a child, forward SIGTERM and SIGINT to it, and return its exit
    code — so a trainer that drains with ``EXIT_PREEMPTED``
    (ft/preemption.py) makes that the pod's exit code, which the
    reconciler reads as preempted, not failed.  A child killed by a
    signal N it did not handle gives 128+N (it never drained)."""
    import signal
    import subprocess

    child = subprocess.Popen(argv)

    def forward(signum, frame):
        try:
            child.send_signal(signum)
        except (ProcessLookupError, OSError):
            pass

    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        prev[sig] = signal.signal(sig, forward)
    try:
        rc = child.wait()
    finally:
        for sig, h in prev.items():
            signal.signal(sig, h)
    return 128 - rc if rc < 0 else rc


def run_pod(argv: List[str], cards: int) -> int:
    """Run a pod of ``cards`` cards: one child a card running ``argv``
    with ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` set, all supervised
    (PID 1 cannot exec several processes, so this holds whatever
    ``TPUJOB_DRAIN`` says).  SIGTERM and SIGINT are forwarded to every
    child.  A child that fails (any code but 0 and ``EXIT_PREEMPTED``;
    128+N for a signal N) fails the pod: the others get SIGTERM, then
    SIGKILL after ``SIBLING_GRACE_S`` (a sibling blocked in a collective with
    the dead child never returns on its own), and the pod exits with
    the failing child's code.  Otherwise the pod exits
    ``EXIT_PREEMPTED`` if any child drained (they drain together: the
    loop agrees over the mesh), else 0."""
    import signal
    import subprocess
    import time

    from paddle_operator_tpu_torch.ft.preemption import EXIT_PREEMPTED

    children = [subprocess.Popen(argv, env=dict(
        os.environ, LOCAL_RANK=str(i), LOCAL_WORLD_SIZE=str(cards)))
        for i in range(cards)]

    def forward(signum, frame):
        for child in children:
            try:
                child.send_signal(signum)
            except (ProcessLookupError, OSError):
                pass

    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        prev[sig] = signal.signal(sig, forward)
    codes: List[Optional[int]] = [None] * cards
    failed: Optional[int] = None
    try:
        while failed is None and None in codes:
            for i, child in enumerate(children):
                if codes[i] is None and child.poll() is not None:
                    rc = child.returncode
                    codes[i] = 128 - rc if rc < 0 else rc
                    if codes[i] not in (0, EXIT_PREEMPTED):
                        failed = codes[i]
            time.sleep(0.02)
        if failed is not None:
            live = [c for c in children if c.poll() is None]
            for c in live:
                c.terminate()
            deadline = time.monotonic() + SIBLING_GRACE_S
            for c in live:
                try:
                    c.wait(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    c.kill()
                    c.wait()
            return failed
    finally:
        for sig, h in prev.items():
            signal.signal(sig, h)
    return EXIT_PREEMPTED if EXIT_PREEMPTED in codes else 0


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m paddle_operator_tpu_torch.launch.launcher -- cmd...``:
    export the slice-local hosts and **exec** the command, replacing
    this process (the child, not the shim, calls :func:`initialize`, so
    one process per rank joins the group).  With ``TPUJOB_DRAIN`` 1,
    true or yes the shim supervises the child instead
    (:func:`run_supervised`): as a container's PID 1 an exec'd trainer
    would ignore an unhandled SIGTERM.  A worker pod of more than one
    card runs one supervised child a card (:func:`run_pod`); a mesh
    that is not a multiple of the worker count exits 1 naming both.

    No command: a worker pod prints its view of the contract (with its
    card count, ``cards``) as one JSON line and exits 0; a ps or heter
    pod exits :data:`EXIT_UNPORTED` naming ROADMAP.md Queue A item 9."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--":
        argv = argv[1:]
    env = JobEnv.from_env()
    _export_hosts(env)
    if not argv and env.res_type in ("ps", "heter"):
        print("launcher: " + _PS_TODO.format(res=env.res_type),
              file=sys.stderr)
        return EXIT_UNPORTED
    try:
        cards = pod_cards(env)
    except ValueError as err:
        print(f"launcher: {err}", file=sys.stderr)
        return 1
    if not argv:
        print(json.dumps({
            "rank": env.rank, "num_workers": env.num_workers,
            "coordinator": env.coordinator_address,
            "mesh": env.mesh.to_dict(), "topology": env.topology,
            "cards": cards,
        }))
        return 0
    if cards > 1 and env.is_xla_worker:
        return run_pod(argv, cards)
    if os.environ.get("TPUJOB_DRAIN", "").lower() in ("1", "true", "yes"):
        return run_supervised(argv)
    sys.stdout.flush()
    os.execvp(argv[0], argv)


if __name__ == "__main__":
    raise SystemExit(main())
