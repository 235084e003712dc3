"""Process groups as meshes. Port of `repro.sharding`'s runtime part:
the `torch.distributed` seam (`compat`), the pod mesh of FL clients
(`flmesh`) and the expert-parallel context (`ctx`). The partition specs
and the production meshes (`specs.py`, `launch/mesh.py`) describe
256-512 chips and belong to the dry run (ROADMAP)."""
from repro_torch.sharding.compat import (
    COLLECTIVES,
    all_reduce_mean,
    all_reduce_sum,
    all_to_all,
    default_group,
    reset_collectives,
)
from repro_torch.sharding.ctx import ep_axis, expert_parallel
from repro_torch.sharding.flmesh import ClientMesh, client_mesh, \
    pad_client_count

__all__ = ["COLLECTIVES", "ClientMesh", "all_reduce_mean", "all_reduce_sum",
           "all_to_all", "client_mesh", "default_group", "ep_axis",
           "expert_parallel", "pad_client_count", "reset_collectives"]
