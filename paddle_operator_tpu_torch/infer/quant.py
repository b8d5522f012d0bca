"""Serving-side parameter preparation — the port of
``paddle_operator_tpu/infer/quant.py``, so far only
:func:`serving_params`.  Weight-only int8/int4 quantization
(``quantize_params``) comes with a later slice (ROADMAP.md Queue A).
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def serving_params(model: nn.Module, dtype) -> nn.Module:
    """Cast the floating-point parameters to the serving/compute dtype
    (normally bf16), in place, and return the module.

    Training keeps f32 master params; serving them directly would stream
    4 bytes/param in the decode hot loop (decode._mm converts at use, so
    the storage dtype IS the streamed dtype).  Buffers (the f32 RoPE
    tables) keep their dtype."""
    for p in model.parameters():
        if p.is_floating_point() and p.dtype != dtype:
            p.data = p.data.to(dtype)
    return model
