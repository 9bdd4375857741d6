"""Multi-device training and scoring over ``torch.distributed`` ranks: the
port of ``mtad_gat_tpu/parallel`` (the banded halo exchange is not ported
yet: ROADMAP.md, Queue 1 item 8b)."""

from mtad_gat_tpu_torch.parallel import multihost
from mtad_gat_tpu_torch.parallel.mesh import best_mesh_shape, make_mesh
from mtad_gat_tpu_torch.parallel.sharding import constrain, current_mesh, use_mesh

__all__ = [
    "make_mesh", "best_mesh_shape", "use_mesh", "current_mesh", "constrain", "multihost",
]
