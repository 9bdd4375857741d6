"""Multi-device training and scoring over ``torch.distributed`` ranks: the
port of ``mtad_gat_tpu/parallel`` (the mesh, the collectives, the ring
attention and the banded halo exchange)."""

from mtad_gat_tpu_torch.parallel import multihost
from mtad_gat_tpu_torch.parallel.banded_halo import banded_halo_attention
from mtad_gat_tpu_torch.parallel.mesh import best_mesh_shape, make_mesh
from mtad_gat_tpu_torch.parallel.sharding import constrain, current_mesh, use_mesh

__all__ = [
    "make_mesh", "best_mesh_shape", "use_mesh", "current_mesh", "constrain", "multihost",
    "banded_halo_attention",
]
