"""Device meshes, the process group and the placements on them (multi-card
enhancement, data-parallel training); see parallel/mesh.py."""

from fullsubnet_plus_torch.parallel.mesh import (
    Mesh,
    auto_mesh,
    data_sharding,
    initialize_distributed,
    is_primary,
    make_mesh,
    replicated,
    row_offset,
)

__all__ = ["Mesh", "auto_mesh", "data_sharding", "initialize_distributed", "is_primary",
           "make_mesh", "replicated", "row_offset"]
