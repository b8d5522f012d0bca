"""Convert the JAX package's flax param tree (and the optax state of
its trainer, with f32 or int8 moments) into the port's ``Llama`` state
dict (and optimizer state).

The input is the flax tree with numpy leaves (``jax.device_get`` of
``model.init(...)["params"]``, or a restored checkpoint's params): a
nested dict whose ``layers`` subtree is the ``nn.scan`` stack — every
leaf under it has a leading ``L`` axis.  The port keeps layers as
separate submodules, so that axis is UNSTACKED: leaf
``layers/attn/wq/kernel [L, in, out]`` becomes ``layers.<i>.attn.wq.
kernel [in, out]`` for each i.  A ``scan_layers=False`` tree names its
layers ``layer_<i>`` instead; those leaves map one to one.

Kernels keep flax's ``[in, out]`` orientation (the port's ``Dense``
computes ``x @ kernel``); nothing is transposed.  bfloat16 leaves
(numpy's ml_dtypes ``bfloat16``, which ``torch.from_numpy`` cannot
read) go through float32, which is exact.

A weight-only quantized tree (the JAX package's ``infer/quant.py``
``quantize_params``) carries ``{"q", "s"}`` leaves in place of
``kernel``: leaf ``.../wq/kernel/q`` becomes ``...wq.q`` and ``.../s``
``...wq.s``, the buffers of the port's quantized ``Dense``.  int4 codes
(numpy's ml_dtypes ``int4``) are widened to int8, exactly.  Load such a
state into a model quantized with the tree's mode and skip list
(``infer/quant.py`` ``quantize_params``), which gives its projections
that form.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def _leaves(tree: Any, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        if set(tree) == {"q", "s"} and path and path[-1] == "kernel":
            yield path[:-1] + ("q",), tree["q"]
            yield path[:-1] + ("s",), tree["s"]
            return
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (str(key),))
    else:
        yield path, tree


def _tensor(arr: Any) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "int4":
        arr = arr.astype(np.int8)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))   # a contiguous copy


def params_from_jax(tree: Any) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) -> state dict for the port's
    ``Llama`` (load it with ``model.load_state_dict(state)``)."""
    state: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(tree):
        unscanned = re.fullmatch(r"layer_(\d+)", path[0])
        if path[0] == "layers":
            stacked = np.asarray(leaf)
            for i in range(stacked.shape[0]):
                key = ".".join(("layers", str(i)) + path[1:])
                state[key] = _tensor(stacked[i])
        elif unscanned:
            state[".".join(("layers", unscanned.group(1)) + path[1:])] = \
                _tensor(leaf)
        else:
            state[".".join(path)] = _tensor(leaf)
    return state


def _states(tree: Any) -> Iterator[Any]:
    """Every namedtuple in a (nested tuple of) optax state(s)."""
    if hasattr(tree, "_fields"):
        yield tree
    if isinstance(tree, (tuple, list)):
        for sub in tree:
            yield from _states(sub)


def _q8_field(tree: Any, field: str) -> Any:
    """The ``field`` (``q8_codes`` or ``q8_scale``) of every ``_Q8`` leaf
    of a moment tree, as a tree of the same dicts."""
    if isinstance(tree, dict):
        return {k: _q8_field(v, field) for k, v in tree.items()}
    return getattr(tree, field)


def opt_state_from_jax(opt_state: Any, cut: Optional[Callable] = None):
    """The optax state of the JAX package's ``make_optimizer`` (numpy
    leaves: ``jax.device_get`` of ``TrainState.opt_state``) -> the
    port's optimizer state under the port's parameter names: an
    :class:`train.trainer.AdamWState` (count, ``mu``, ``nu``) from
    ``moments="f32"``'s ``ScaleByAdamState``, an
    :class:`train.opt8bit.AdamW8bitState` from ``moments="int8"``'s
    ``ScaleByAdam8bitState`` (each ``[L, ...]`` codes and scales leaf
    unstacked into the layers' names, as the parameters are).  The
    schedule's count must equal the Adam count (both advance once per
    update).

    ``cut(field, name)``: the slices of a rank's region of that field's
    global tensor (``mu``/``nu``, or ``mu_codes`` ... ``nu_scales``;
    for int8 ``parallel/sharding.py`` ``Q8Layout.field(field)[2]``), or
    None to keep it whole: the state a rank of a mesh holds."""
    from paddle_operator_tpu_torch.train import opt8bit
    from paddle_operator_tpu_torch.train.trainer import AdamWState

    adam = [s for s in _states(opt_state)
            if {"count", "mu", "nu"} <= set(s._fields)]
    sched = [s for s in _states(opt_state) if tuple(s._fields) == ("count",)]
    if len(adam) != 1 or len(sched) != 1:
        raise NotImplementedError(
            "opt_state_from_jax reads the AdamW state of make_optimizer "
            "(one ScaleByAdamState or ScaleByAdam8bitState and one "
            "schedule count); other optimizer states are not ported")
    count = int(np.asarray(adam[0].count))
    if int(np.asarray(sched[0].count)) != count:
        raise ValueError(f"schedule count {int(np.asarray(sched[0].count))}"
                         f" != Adam count {count}")
    mu, nu = adam[0].mu, adam[0].nu

    def region(field: str, tensors: Dict[str, torch.Tensor]):
        if cut is None:
            return tensors
        out = {}
        for k, t in tensors.items():
            sl = cut(field, k)
            out[k] = t if sl is None else t[tuple(sl)].contiguous()
        return out

    if type(adam[0]).__name__ != "ScaleByAdam8bitState":
        return AdamWState(count=count, mu=region("mu", params_from_jax(mu)),
                          nu=region("nu", params_from_jax(nu)))

    def q8(tree, moment):
        codes = region(moment + "_codes",
                       params_from_jax(_q8_field(tree, "q8_codes")))
        scales = region(moment + "_scales",
                        params_from_jax(_q8_field(tree, "q8_scale")))
        return {k: opt8bit.Q8(codes[k], scales[k]) for k in codes}

    return opt8bit.AdamW8bitState(count=count, mu=q8(mu, "mu"),
                                  nu=q8(nu, "nu"))
