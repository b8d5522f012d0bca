"""The two names of ``paddle_operator_tpu/api/types.py`` that the pod's
env contract needs (``launch/launcher.py``): the logical mesh the
ConfigMap carries as ``TPUJOB_MESH``, and the default coordinator port.
Own copy: the port imports nothing of the JAX package, and the CRD
types stay there.  Tests hold the two copies equal.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

# the default TPUJOB_PORT the operator injects (the coordinator's)
COORDINATOR_PORT = 8476


@dataclass
class MeshSpec:
    """Logical parallelism axes carried in the CRD (``dp`` data, ``fsdp``
    fully-sharded data, ``tp`` tensor, ``pp`` pipeline, ``cp`` context,
    ``ep`` expert).  Their product is the job's chip count."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    pp: int = 1
    cp: int = 1
    ep: int = 1

    AXES = ("dp", "fsdp", "tp", "pp", "cp", "ep")

    def size(self) -> int:
        n = 1
        for a in self.AXES:
            n *= getattr(self, a)
        return n

    def to_dict(self) -> Dict[str, Any]:
        return {a: getattr(self, a) for a in self.AXES if getattr(self, a) != 1}

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> Optional["MeshSpec"]:
        if d is None:
            return None
        return cls(**{a: int(d.get(a, 1)) for a in cls.AXES})
