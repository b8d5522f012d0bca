"""Convert the JAX package's flax param tree (and the optax state of
its trainer) into the port's ``Llama`` state dict (and optimizer
state).

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
read) go through float32, which is exact.  Weight-only int8
``{"q", "s"}`` leaves (infer/quant.py of the JAX package) are refused
until the quantization slice.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def _leaves(tree: Any, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        if "q" in tree and "s" in tree:
            raise NotImplementedError(
                f"weight-only int8 leaf at {'/'.join(path)}: quantized "
                "param trees are not ported to the torch package yet "
                "(ROADMAP.md Queue A, infer/quant.py)")
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (str(key),))
    else:
        yield path, tree


def _tensor(arr: Any) -> torch.Tensor:
    arr = np.asarray(arr)
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


def opt_state_from_jax(opt_state: Any):
    """The optax state of the JAX package's ``make_optimizer`` (numpy
    leaves: ``jax.device_get`` of ``TrainState.opt_state``) -> the
    port's :class:`train.trainer.AdamWState`: the Adam count, ``mu``
    and ``nu`` under the port's parameter names.  The schedule's count
    must equal the Adam count (both advance once per update); the int8
    moments of ``moments="int8"`` are refused (train/opt8bit.py is not
    ported)."""
    from paddle_operator_tpu_torch.train.trainer import AdamWState

    adam = [s for s in _states(opt_state)
            if {"count", "mu", "nu"} <= set(s._fields)]
    sched = [s for s in _states(opt_state) if tuple(s._fields) == ("count",)]
    if len(adam) != 1 or len(sched) != 1:
        raise NotImplementedError(
            "opt_state_from_jax reads the f32-moment AdamW state of "
            "make_optimizer (one ScaleByAdamState and one schedule "
            "count); other optimizer states, the int8 moments of "
            "moments='int8' included, are not ported (ROADMAP.md Queue "
            "A item 13)")
    count = int(np.asarray(adam[0].count))
    if int(np.asarray(sched[0].count)) != count:
        raise ValueError(f"schedule count {int(np.asarray(sched[0].count))}"
                         f" != Adam count {count}")
    return AdamWState(count=count, mu=params_from_jax(adam[0].mu),
                      nu=params_from_jax(adam[0].nu))
