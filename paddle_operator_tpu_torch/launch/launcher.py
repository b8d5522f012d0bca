"""In-pod env contract — own copy of the part of
``paddle_operator_tpu/launch/launcher.py`` ``JobEnv.from_env`` that the
serving entry point reads.  No distributed init: the serving slice runs
one process on one card.  The rest of the contract (ranks, mesh,
worker hosts, ``torch.distributed`` init) comes with the parallelism
slice (ROADMAP.md Queue A).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

# the coordinator port of the JAX package's api/types.py — the default
# TPUJOB_PORT the operator injects
COORDINATOR_PORT = 8476


@dataclass
class JobEnv:
    """Parsed view of the env keys one serving pod reads."""

    port: int = COORDINATOR_PORT
    checkpoint_path: str = ""

    @classmethod
    def from_env(cls, environ=None) -> "JobEnv":
        e = environ if environ is not None else os.environ
        return cls(
            port=int(e.get("TPUJOB_PORT", COORDINATOR_PORT)),
            checkpoint_path=e.get("TPUJOB_CHECKPOINT_PATH", ""),
        )
