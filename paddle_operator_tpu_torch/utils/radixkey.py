"""The radix prefix chain key — own copy of
``paddle_operator_tpu/utils/radixkey.py``, shared by the port's paged
KV cache and (through equal keys) the fleet router.  The keys must
equal the JAX package's: the router keys its affinity on them, so a
port replica and a JAX replica hit the same prefixes.

One function, two consumers:

- ``infer/paged.py`` keys its host radix cache on :func:`chain_key`
  chains over full token blocks (``PagedCacheManager._chain_key``
  delegates here), so a replica's prefix-cache hit is a walk over
  these keys;
- ``router/`` keys its consistent-hash affinity on
  :func:`prefix_chain_key` over the SAME chain, so the replica the
  router picks for a prefix is, by construction, the replica whose
  radix cache holds that prefix's blocks — there is no second hashing
  scheme to drift out of agreement.

Determinism: the chain folds Python ``hash`` over tuples of ints.
Ints hash to themselves and tuple hashing is an unseeded combination
of element hashes, so — unlike strings — the value is stable across
processes and interpreter restarts (``PYTHONHASHSEED`` only salts
str/bytes).  The chain ROOT is the int 0, never ``None``:
``hash(None)`` is identity-derived before Python 3.12 and therefore
differs between processes under ASLR — a ``hash((None, chunk))`` root
would silently disagree between the router pod and every replica.
Router and replicas may therefore run in different pods and still
agree.  This module must stay import-light (no jax): the router
process is jax-free.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

_ROOT = 0   # chain start; see the determinism note above


def chain_key(parent: Optional[int], chunk: Tuple[int, ...]) -> int:
    """Rolling key for one full block: hash-chained on the parent key
    (``None`` = chain start) so equal chunks under different prefixes
    never collide; the paged cache stores the raw chunk so a
    (vanishingly unlikely) collision is caught by its equality check
    at lookup."""
    return hash((_ROOT if parent is None else parent, chunk))


def prefix_chain_key(tokens: Iterable[int], block_size: int,
                     max_blocks: int = 2) -> Tuple[int, int]:
    """Affinity key for a prompt: the chain key of its first
    ``min(max_blocks, len // block_size)`` FULL blocks — the prefix
    granularity the replica radix cache can actually share.  Returns
    ``(key, full_blocks_used)``.

    A prompt shorter than one block has nothing block-granular to
    share; it is keyed on the raw (partial) token tuple instead so
    identical short prompts still group onto one replica (their
    partial-tail radix hits live there), while ``full_blocks_used``
    stays 0 so the caller can tell the two regimes apart."""
    toks = tuple(int(t) for t in tokens)
    n_full = min(len(toks) // block_size, max_blocks)
    if n_full == 0:
        return chain_key(None, toks), 0
    key: Optional[int] = None
    for j in range(n_full):
        key = chain_key(key, toks[j * block_size:(j + 1) * block_size])
    return key, n_full  # type: ignore[return-value]
