"""Tensor-parallel serving over one process a card: ONE scheduler, every
rank replaying its decisions.

The JAX package serves ``SERVE_TP=N`` from one process that drives N
chips; PyTorch has no single controller over several cards, so the port
runs a process a card (``infer/serve.py`` starts them) and makes three
things explicit:

- **one process a card**, each holding its cut of the model
  (``infer/decode.py`` ``init_serving_shard``) and a ``RingExecutor``
  over its kv heads of the KV cache;
- **explicit collectives** inside every device program (the
  all-reduces after wo and w2, the vocab-parallel embedding, the
  all-gather of the logits), so the ranks' programs must be the same
  programs, in the same order, on the same inputs;
- **one scheduler whose decisions every rank replays**: rank 0 (the
  leader) runs the HTTP server and ``ContinuousBatcher``; its executor
  is a :class:`LeaderExecutor`, which sends every call the scheduler
  makes on the executor — the method's name and its host arguments —
  over the mesh's gloo control group before it runs the call itself;
  each other rank runs :func:`follow`, which replays the calls on its
  own executor in the order they came.

What crosses is host data only: a scheduler-made tensor (a prompt, a
table row) crosses as a CPU copy that the follower puts on its own
card, the executor's own state (params, cache, tok, temp, seeds, the
LoRA slot view) as a name the follower resolves on its executor, and a
staging lane or a spill as a handle the follower keys its own by.  A
follower never holds a tensor of rank 0's.  The host state only the
leader updates — the block allocator and its radix cache, the lanes'
positions, ``aid_host`` — reaches the followers inside the calls'
arguments (the plan's table, the ``ids`` of a spill or restore).

Spill and restore: each rank spills and restores its own kv-head slice
of the lane's blocks; the leader keeps the handle (``spill["tp_handle"]``)
and restores only onto the same ring.  Adapter loads and evicts run on
every rank (:class:`LeaderAdapters`).

The channel's lock orders the calls: a call is sent and run under it,
so the order the followers replay is the order the leader ran, and the
collectives inside the programs pair up.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

# the executor's state a call may name instead of carrying
_STATE = ("params", "draft_params", "cache", "dcache", "tok", "temp",
          "seeds", "aid")
# the executor methods a scheduler call replays on every rank
_CALLS = frozenset({"set_aid", "replay", "run", "reset_state",
                    "capture_graphs", "scrub_lane", "prewarm"})
# the methods that return a program the scheduler then calls
_FACTORIES = frozenset({"suffix_insert", "chunk_prog", "final_insert"})


class _Ref:
    def __init__(self, name: str) -> None:
        self.name = name


class _Lora:
    def __init__(self, slot: int) -> None:
        self.slot = slot


class _Handle:
    def __init__(self, hid: int, part: int) -> None:
        self.hid, self.part = hid, part


class _Data:
    """A tensor's host copy and the card type it lives on."""

    def __init__(self, t: torch.Tensor) -> None:
        self.t = t.detach().to("cpu", copy=True)


class ControlChannel:
    """Rank 0's messages to the other ranks of a serving mesh, pickled
    over its gloo control group (``parallel/mesh.py`` ``control_group``):
    ``send`` on the leader, ``recv`` on a follower, in one order."""

    def __init__(self, group) -> None:
        self.group = group
        self.lock = threading.RLock()

    def send(self, msg) -> None:
        dist.broadcast_object_list([msg], src=0, group=self.group)

    def recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


class _Program:
    """A program of the leader's executor, mirrored when called."""

    def __init__(self, leader: "LeaderExecutor", key: tuple, fn) -> None:
        self.leader, self.key, self.fn = leader, key, fn

    def __call__(self, *args, **kw):
        return self.leader._run(("prog", self.key), self.fn, args, kw)


class _Inserts:
    def __init__(self, leader: "LeaderExecutor") -> None:
        self.leader = leader

    def __getitem__(self, bucket):
        fn = self.leader._ex.inserts[bucket]
        return _Program(self.leader, ("inserts", bucket), fn)


class LeaderExecutor:
    """Rank 0's ``RingExecutor`` on a tensor-parallel ring: every
    attribute is the executor's, and every call the scheduler makes on
    it (a method of :data:`_CALLS`, a program of ``inserts`` or of a
    factory, the block copies, a staging lane, a spill or a restore) is
    sent to the followers before it runs here."""

    def __init__(self, ex, channel: ControlChannel) -> None:
        object.__setattr__(self, "_ex", ex)
        object.__setattr__(self, "_ch", channel)
        object.__setattr__(self, "_next", 0)
        object.__setattr__(self, "_staged", {})     # id -> (hid, part)
        object.__setattr__(self, "_released", [])
        object.__setattr__(self, "_loras", {})      # slot -> tuple
        object.__setattr__(self, "_stopped", False)

    def __getattr__(self, name: str):
        ex = self._ex
        if name in _CALLS:
            fn = getattr(ex, name)
            return lambda *a, **kw: self._run(("call", name), fn, a, kw)
        if name in _FACTORIES:
            make = getattr(ex, name)
            return lambda *a: _Program(self, (name, a), make(*a))
        if name in ("_copy_block", "_tail_init"):
            fn = getattr(ex, name)
            return None if fn is None else _Program(self, ("attr", name),
                                                    fn)
        if name == "inserts":
            return _Inserts(self)
        return getattr(ex, name)

    def __setattr__(self, name: str, value) -> None:
        if name in _CALLS:
            # a wrapper of a mirrored call (a test's pacing, the chaos
            # injector) wraps the mirrored call: it stays here, so the
            # call is sent once
            object.__setattr__(self, name, value)
        else:
            setattr(self._ex, name, value)

    # -- the wire ---------------------------------------------------------

    def _hid(self) -> int:
        hid = self._next
        object.__setattr__(self, "_next", hid + 1)
        return hid

    def _send(self, msg) -> None:
        if self._stopped:
            raise RuntimeError("the tensor-parallel ring's followers "
                               "were stopped")
        if self._released:
            gone, self._released[:] = list(self._released), []
            self._ch.send(("release", gone, None))
        self._ch.send(msg)

    def _enc(self, obj):
        ex = self._ex
        if obj is None or isinstance(obj, (bool, int, float, str,
                                           np.ndarray, np.generic)):
            return obj
        for name in _STATE:
            if obj is getattr(ex, name, None):
                return _Ref(name)
        if isinstance(obj, tuple):
            for slot, t in self._loras.items():
                if obj is t:
                    return _Lora(slot)
            return tuple(self._enc(o) for o in obj)
        if isinstance(obj, list):
            return [self._enc(o) for o in obj]
        if isinstance(obj, dict):
            return {k: self._enc(v) for k, v in obj.items()}
        if torch.is_tensor(obj):
            h = self._staged.get(id(obj))
            if h is not None:
                return _Handle(*h)
            return _Data(obj)
        if type(obj).__name__ == "ExecPlan":
            return obj
        raise TypeError(f"a tensor-parallel ring cannot send a "
                        f"{type(obj).__name__} to its followers")

    def _run(self, key, fn, args, kw):
        with self._ch.lock:
            self._send((key, self._enc(args), self._enc(kw)))
            return fn(*args, **kw)

    # -- calls with leader-side state ---------------------------------------

    def lora_insert_tail(self, slot: int):
        out = self._ex.lora_insert_tail(slot)
        if out is not None:
            self._loras[slot] = out
        return out

    def make_staging(self, bucket: int):
        with self._ch.lock:
            hid = self._hid()
            self._send((("staging", bucket), hid, None))
            pair = self._ex.make_staging(bucket)
            for part, t in enumerate(pair):
                self._staged[id(t)] = (hid, part)
                weakref.finalize(t, self._forget, id(t), hid, part)
            return pair

    def _forget(self, key: int, hid: int, part: int) -> None:
        self._staged.pop(key, None)
        if part == 0:
            self._released.append(hid)

    def spill_lane(self, slot: int) -> Dict[str, Any]:
        with self._ch.lock:
            pm = self._ex.pool
            ids = [int(b) for b in pm.table[slot][:int(pm.mapped_count[slot])]]
            hid = self._hid()
            self._send((("spill", slot), hid, ids))
            spill = self._ex.spill_lane(slot)
            spill["tp_handle"] = hid
            return spill

    def restore_lane(self, slot: int, spill: Dict[str, Any]) -> None:
        with self._ch.lock:
            self._ex.restore_lane(slot, spill)
            m = int(spill["n_blocks"])
            ids = [int(b) for b in self._ex.pool.table[slot][:m]]
            self._send((("restore", slot), spill["tp_handle"], ids))

    def drop_spill(self, spill: Dict[str, Any]) -> None:
        with self._ch.lock:
            self._send((("drop_spill", None), spill["tp_handle"], None))

    def stop_followers(self) -> None:
        """End every follower's replay loop (the ring is closing).  Best
        effort: a call stuck in its collectives keeps the channel."""
        if not self._ch.lock.acquire(timeout=5):
            return
        try:
            if not self._stopped:
                self._send((("stop", None), None, None))
                object.__setattr__(self, "_stopped", True)
        finally:
            self._ch.lock.release()


class LeaderAdapters:
    """Rank 0's adapter registry on a tensor-parallel ring: a load or an
    evict is sent to the followers (whose registries stay equal) and run
    here; everything else is the registry's."""

    def __init__(self, reg, channel: ControlChannel) -> None:
        self._reg, self._ch = reg, channel

    def __getattr__(self, name: str):
        return getattr(self._reg, name)

    def __len__(self) -> int:
        return len(self._reg)

    def _mirrored(self, name, *args, **kw):
        with self._ch.lock:
            self._ch.send((("adapters", name), args, kw))
            return getattr(self._reg, name)(*args, **kw)

    def load(self, *args, **kw):
        return self._mirrored("load", *args, **kw)

    def evict(self, *args, **kw):
        return self._mirrored("evict", *args, **kw)


def _dec(ex, obj, handles):
    if isinstance(obj, _Ref):
        return getattr(ex, obj.name)
    if isinstance(obj, _Lora):
        return ex.lora_insert_tail(obj.slot)
    if isinstance(obj, _Handle):
        return handles[obj.hid][obj.part]
    if isinstance(obj, _Data):
        return obj.t.to(ex.device)
    if isinstance(obj, tuple):
        return tuple(_dec(ex, o, handles) for o in obj)
    if isinstance(obj, list):
        return [_dec(ex, o, handles) for o in obj]
    if isinstance(obj, dict):
        return {k: _dec(ex, v, handles) for k, v in obj.items()}
    return obj


def follow(ex, channel: ControlChannel, adapters=None) -> int:
    """A follower rank's loop: replay the leader's calls on ``ex`` (this
    rank's ``RingExecutor``) and ``adapters`` (its registry) in the
    order they come, until the leader stops the ring; returns 0.  A call
    that raises here ends the loop with the exception: the ranks'
    programs would no longer pair up, so the replica must end."""
    handles: Dict[int, Any] = {}
    spills: Dict[int, Dict[str, Any]] = {}
    with torch.inference_mode():
        while True:
            msg = channel.recv()
            head, a, b = msg
            if head == "release":
                for hid in a:
                    handles.pop(hid, None)
                continue
            kind, arg = head
            if kind == "stop":
                return 0
            if kind == "call":
                getattr(ex, arg)(*_dec(ex, a, handles),
                                 **_dec(ex, b, handles))
            elif kind == "prog":
                fac, farg = arg
                if fac == "inserts":
                    fn = ex.inserts[farg]
                elif fac == "attr":
                    fn = getattr(ex, farg)
                else:
                    fn = getattr(ex, fac)(*farg)
                fn(*_dec(ex, a, handles), **_dec(ex, b, handles))
            elif kind == "staging":
                handles[a] = ex.make_staging(arg)
            elif kind == "spill":
                spills[a] = ex.spill_lane(arg, ids=b)
            elif kind == "restore":
                ex.restore_lane(arg, spills.pop(a), ids=b)
            elif kind == "drop_spill":
                spills.pop(a, None)
            elif kind == "adapters":
                getattr(adapters, arg)(*a, **b)
            else:
                raise ValueError(f"unknown tensor-parallel ring message "
                                 f"{head!r}")


def channel_for(mesh) -> Optional[ControlChannel]:
    """The control channel of a serving mesh of more than one rank."""
    from paddle_operator_tpu_torch.parallel.mesh import control_group

    group = control_group(mesh)
    return None if group is None else ControlChannel(group)


def follow_batch(params, cfg, mesh, channel: ControlChannel) -> int:
    """A follower rank of a tensor-parallel BATCH server (``infer/
    serve.py`` ``Generator``): run each ``decode.generate`` call the
    leader sends, with the same arguments, on this rank's cut; returns
    0 when the leader stops."""
    from paddle_operator_tpu_torch.infer import decode as D

    device = params.tok_embed.embedding.device
    with torch.inference_mode():
        while True:
            head, kw, _ = channel.recv()
            if head[0] == "stop":
                return 0
            kw = dict(kw)
            prompt = torch.as_tensor(kw.pop("tokens"), device=device)
            seed = kw.pop("seed")
            gen = None
            if kw["temperature"] > 0:
                gen = torch.Generator(device=device)
                gen.manual_seed(seed)
            D.generate(params, cfg, prompt, generator=gen, mesh=mesh, **kw)
