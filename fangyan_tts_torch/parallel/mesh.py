"""The process mesh of multi-device runs (fangyan_tts_tpu/parallel/mesh.py).

Axes, in the JAX package's order:
- 'dp'   data parallel (batch rows; gradients summed over it)
- 'fsdp' parameter sharding (ZeRO-3 analogue); also a data axis for rows
- 'tp'   tensor parallel (attention heads, MLP hidden, vocabularies)

One process a mesh position. The processes are started by `torchrun`
(torch.distributed.run, which sets RANK / WORLD_SIZE / MASTER_ADDR /
MASTER_PORT) or by parallel/launch.spawn. `make_mesh` joins the default
process group if the caller has not (gloo on the CPU, nccl when each rank
has a GPU of its own) and builds the axis groups with
torch.distributed.device_mesh.init_device_mesh over (dp, fsdp, tp); ranks
are laid out row-major, tp fastest. Two ranks that share one GPU must use
gloo (nccl refuses them): pass backend="gloo".

A `Mesh(dp, fsdp, tp)` built directly has no process groups: its axis
sizes are enough for the placement rules of parallel/sharding.py, which
need no collective.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

AXES = ("dp", "fsdp", "tp")


@dataclass(frozen=True)
class Mesh:
    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    coord: tuple[int, int, int] = (0, 0, 0)  # this process's (dp, fsdp, tp) position
    groups: dict = field(default_factory=dict, repr=False, compare=False)  # axis / "data" -> ProcessGroup

    def __deepcopy__(self, memo):  # process groups are handles: a copied module keeps its mesh
        return self

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as jax.sharding.Mesh.shape."""
        return {"dp": self.dp, "fsdp": self.fsdp, "tp": self.tp}

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.tp

    @property
    def data_size(self) -> int:
        """The number of distinct row shards: dp x fsdp."""
        return self.dp * self.fsdp

    @property
    def data_index(self) -> int:
        """This process's row shard (ranks that differ only in tp share it)."""
        return self.coord[0] * self.fsdp + self.coord[1]

    def rank(self, axis: str) -> int:
        return self.coord[AXES.index(axis)] if axis != "data" else self.data_index

    def group(self, axis: str):
        """The process group over `axis` ('dp', 'fsdp', 'tp', 'data' for
        dp x fsdp, or 'world') that holds this process; None where the axis
        has size 1."""
        n = {"data": self.data_size, "world": self.size}.get(axis) or self.shape[axis]
        if n == 1:
            return None
        return dist.group.WORLD if axis == "world" else self.groups[axis]


def _world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return int(os.environ.get("RANK", "0")), int(os.environ.get("WORLD_SIZE", "1"))


def make_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1, device: str | torch.device | None = None,
              backend: str | None = None) -> Mesh:
    """The dp x fsdp x tp mesh over every process of the job. Raises when
    dp * fsdp * tp is not the world size (it never runs on part of the
    world). A world of one process needs no process group; else the default
    group is joined from the environment if it is not yet: `backend` gloo
    for a CPU `device` (the tests), nccl for CUDA, where each rank is bound
    to card LOCAL_RANK."""
    need = dp * fsdp * tp
    rank, world = _world()
    if min(dp, fsdp, tp) < 1 or need != world:
        raise ValueError(f"mesh dp={dp} x fsdp={fsdp} x tp={tp} needs {need} processes; the job has {world} "
                         "(start it with torchrun --nproc_per_node N, WORLD_SIZE = N)")
    if world == 1:
        return Mesh(dp, fsdp, tp)
    dev = torch.device("cuda" if device is None else device)
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda" and backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend, rank=rank, world_size=world)
    from torch.distributed.device_mesh import init_device_mesh

    # the mesh's device type only names the groups' default device; collectives
    # go through the default group's backend
    dm = init_device_mesh("cuda" if dist.get_backend() == "nccl" else "cpu", (dp, fsdp, tp), mesh_dim_names=AXES)
    coord = tuple(int(c) for c in dm.get_coordinate())
    groups = {a: dm.get_group(a) for a in AXES}
    # the data group (dp x fsdp at one tp position): every process creates every group, in one order
    ranks = dm.mesh.reshape(dp * fsdp, tp)
    mine, _ = dist.new_subgroups_by_enumeration([ranks[:, t].tolist() for t in range(tp)])
    groups["data"] = mine
    return Mesh(dp, fsdp, tp, coord, groups)


def local_mesh(device: str | torch.device | None = None, backend: str | None = None) -> Mesh:
    """Every process of the job on the dp axis (the common fine-tune
    topology)."""
    return make_mesh(dp=_world()[1], device=device, backend=backend)
