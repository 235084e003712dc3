"""Production meshes and the H100's constants for the roofline.

Port of `repro.launch.mesh`. Single pod: (data=16, model=16) = 256
devices. Multi-pod: (pod=2, data=16, model=16) = 512 devices — the "pod"
axis carries the FL/data-parallel all-reduce (pods ~ orbital clusters in
the satellite mapping).

The meshes are device-free (`sharding.compat.abstract_mesh`): building
one, or importing this module, touches no process group. The dry run
(`launch/dryrun.py`) lays DTensors over them through
`sharding.compat.device_mesh`.

The reference prices TPU v5e chips; the port prices one NVIDIA H100 SXM
per mesh device, from NVIDIA's H100 Tensor Core GPU data sheet (SXM5
column): 989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s f32
outside them, 3.35 TB/s of HBM3, and 900 GB/s of NVLink a GPU, counted
both ways, so 450 GB/s each way. A 256-device mesh spans 32 eight-GPU
nodes, and an axis that crosses nodes runs over the network between
them, far below NVLink's rate: the collective term flatters any such
axis. The roofline keeps the reference's three terms (compute, memory,
collective), each over one device's rate.
"""
from __future__ import annotations

from repro_torch.sharding.compat import AbstractMesh, abstract_mesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return abstract_mesh(shape, axes)


def make_host_mesh() -> AbstractMesh:
    """1-device mesh for CPU smoke runs (same axis names, size 1)."""
    return abstract_mesh((1, 1), ("data", "model"))


# NVIDIA H100 SXM constants for the roofline (per device).
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense, tensor cores
F32_FLOPS_PER_S = 67e12           # FLOP/s, f32 outside the tensor cores
HBM_BW = 3.35e12                  # bytes/s
NVLINK_BW = 450e9                 # bytes/s each way (900 GB/s both ways)
