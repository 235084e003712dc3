"""Process groups as meshes. Port of `repro.sharding`: the
`torch.distributed` seam and the dry run's device-free meshes
(`compat`), the pod mesh of FL clients (`flmesh`), the activation-
sharding and expert-parallel contexts (`ctx`) and the partition specs
of the production meshes (`specs`)."""
from repro_torch.sharding.compat import (
    COLLECTIVES,
    abstract_mesh,
    all_reduce_mean,
    all_reduce_sum,
    all_to_all,
    default_group,
    reset_collectives,
)
from repro_torch.sharding.ctx import ep_axis, expert_parallel
from repro_torch.sharding.flmesh import ClientMesh, client_mesh, \
    pad_client_count
from repro_torch.sharding.specs import (
    MeshAxes,
    batch_pspec,
    cache_pspecs,
    param_pspecs,
)

__all__ = ["COLLECTIVES", "ClientMesh", "MeshAxes", "abstract_mesh",
           "all_reduce_mean", "all_reduce_sum", "all_to_all", "batch_pspec",
           "cache_pspecs", "client_mesh", "default_group", "ep_axis",
           "expert_parallel", "pad_client_count", "param_pspecs",
           "reset_collectives"]
