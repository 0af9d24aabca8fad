"""Multi-chip parallelism.

The deployment path is ``DomainHipscEngine`` (spatial domain decomposition
over an ``(n_tx, n_ty)`` tile grid, x-stripes being ``n_ty=1``: O(boundary)
``ppermute`` collectives, agent migration). ``parallel.mesh.ShardedHipscEngine``
(GSPMD agent sharding) is a correctness cross-check with O(colony)
collectives — deliberately NOT re-exported here so it cannot be picked by accident.

``EnsembleEngine`` is the orthogonal axis: R independent replicate
colonies (or a traced parameter sweep) vmapped into one compiled step and
optionally sharded replicate-per-device over a mesh with zero collectives.
"""

from hipsc_abm.parallel.domain_engine import (  # noqa: F401
    DomainHipscEngine,
    DomainState,
)
from hipsc_abm.parallel.ensemble import EnsembleEngine  # noqa: F401

__all__ = ["DomainHipscEngine", "DomainState", "EnsembleEngine"]
