"""Convert the JAX package's flax param tree into the port's ``Llama``
state dict.

The input is the flax tree with numpy leaves (``jax.device_get`` of
``model.init(...)["params"]``, or a restored checkpoint's params): a
nested dict whose ``layers`` subtree is the ``nn.scan`` stack — every
leaf under it has a leading ``L`` axis.  The port keeps layers as
separate submodules, so that axis is UNSTACKED: leaf
``layers/attn/wq/kernel [L, in, out]`` becomes ``layers.<i>.attn.wq.
kernel [in, out]`` for each i.

Kernels keep flax's ``[in, out]`` orientation (the port's ``Dense``
computes ``x @ kernel``); nothing is transposed.  bfloat16 leaves
(numpy's ml_dtypes ``bfloat16``, which ``torch.from_numpy`` cannot
read) go through float32, which is exact.  Weight-only int8
``{"q", "s"}`` leaves (infer/quant.py of the JAX package) are refused
until the quantization slice.
"""

from __future__ import annotations

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
        if path[0] == "layers":
            stacked = np.asarray(leaf)
            for i in range(stacked.shape[0]):
                key = ".".join(("layers", str(i)) + path[1:])
                state[key] = _tensor(stacked[i])
        else:
            state[".".join(path)] = _tensor(leaf)
    return state
