"""FL client meshes: a "pod" axis for cluster-as-collective execution.

Port of `repro.sharding.flmesh`. The reference lays the pod axis over
`min(n_devices, n_clients)` devices and each shard vmaps its block of
pods; the port lays it over the ranks of a `torch.distributed` process
group, and each rank trains its contiguous block of pod slots as one
client stack. Callers pad their client batch to a multiple of the axis
size (`pad_client_count`) with zero-weight slots, the collective
equivalent of an out-of-contact satellite.

Deviation: the pod axis is always the whole group. With fewer clients
than ranks, a rank whose block is all padding trains nothing that
counts, but still joins every collective; the results are the same. So
`client_mesh` takes no client count, and no axis name: a process group
has one axis.
"""
from __future__ import annotations

import dataclasses

import torch.distributed as dist

from repro_torch.sharding.compat import default_group


@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """A process group seen as a 1-D mesh whose one axis carries pods."""

    group: object
    rank: int
    size: int

    def block(self, n_slots: int) -> slice:
        """This rank's contiguous block of `n_slots` pod slots (a
        multiple of `size`)."""
        if n_slots % self.size:
            raise ValueError(f"{n_slots} pod slots do not split over "
                             f"{self.size} ranks; pad with "
                             "pad_client_count")
        per = n_slots // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def client_mesh(*, group=None, device=None) -> ClientMesh:
    """The pod mesh over `group` (default: `default_group(device)`)."""
    if group is None:
        group = default_group(device)
    return ClientMesh(group, dist.get_rank(group),
                      dist.get_world_size(group))


def pad_client_count(n_clients: int, mesh: ClientMesh) -> int:
    """Smallest multiple of the mesh's axis size >= n_clients."""
    size = mesh.size
    return ((max(1, int(n_clients)) + size - 1) // size) * size
