"""PyTorch/CUDA port of ``paddle_operator_tpu``'s serving path.

The JAX package stays the reference; this package mirrors its module
layout so each module's counterpart is found under the same relative
path (``models/llama.py``, ``infer/decode.py``, ``infer/serve.py``, ...).
It imports ``torch`` and never ``jax``, and nothing of the JAX package:
what it needs from that package's jax-free helpers it keeps as its own
copy.

Entry points run on the CUDA card unless the caller asks for the CPU.
On a CPU tensor every kernel wrapper uses its plain PyTorch version (the
CPU tests); on a CUDA tensor it launches its hand-written kernel or
raises.
"""
