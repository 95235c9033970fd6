"""Process groups, device meshes and sharding helpers for the env farm and
the learner.

The port of the JAX package's `parallel/mesh.py`. JAX drives every device of
a host from one process and partitions jitted functions over a `Mesh`;
PyTorch runs one process per card (`torchrun`, or `torch.multiprocessing`),
so the port's mesh is a `torch.distributed.device_mesh.DeviceMesh` over the
ranks of the default process group, and each rank holds one contiguous block
of the farm's envs: rank r of an `env` dimension of size R holds envs
[r * B/R, (r + 1) * B/R) of a farm of B. The step is elementwise over envs,
so stepping a shard needs no communication; the learner's reductions
(gradients, observation statistics, metrics) are all-reduces over the
mesh's `env` dimension. On a 2-D (env, model) mesh the envs split over
`env` and are replicated over `model`, as `P("env")` places them on JAX's
2-D mesh.

Without a mesh (`mesh=None` everywhere), one process holds the whole farm
and no process group is needed.
"""
from __future__ import annotations

import hashlib
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

ENV_AXIS = "env"
MODEL_AXIS = "model"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_rank: Optional[int] = None, cpu: bool = False,
                     backend: Optional[str] = None) -> Optional[torch.device]:
    """Join a run of `num_processes` processes as rank `process_id`, and
    return this rank's device. A no-op returning None when the run is a
    single process (`num_processes` None or <= 1), unless `backend` is given
    (a one-rank group, as the single-card check of `chip_smoke.py` makes).

    The group meets at `tcp://coordinator_address` (host:port; an address
    holding "://" is taken as the init method itself, e.g. `file://...`).
    The backend is NCCL when the run is on the card and gloo on the CPU
    (`cpu`), or `backend` when given; nothing falls back from one to the
    other. On the card the rank's device is `cuda:local_rank` (default
    `process_id` modulo the cards of the host), made the current device."""
    if backend is None and (num_processes is None or num_processes <= 1):
        return None
    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if coordinator_address is None:
        raise ValueError("a run of several processes needs a coordinator_address")
    if backend is None:
        backend = "gloo" if cpu else "nccl"
    if cpu:
        device = torch.device("cpu")
    else:
        if local_rank is None:
            local_rank = rank % torch.cuda.device_count()
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    method = (coordinator_address if "://" in coordinator_address
              else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=method, world_size=world, rank=rank)
    return device


def _device_type(devices) -> str:
    """The mesh's device type: `devices`, else "cuda" for an NCCL group and
    "cpu" for a gloo one (the mesh only names the group's ranks: the
    learner's tensors stay on each rank's own device)."""
    if devices is not None:
        return torch.device(devices).type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _need_group(what: str) -> None:
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs a process group: call init_distributed "
                           "first (or run under torchrun); without one, pass "
                           "mesh=None")


def make_env_mesh(devices: Optional[str] = None, axis_name: str = ENV_AXIS):
    """1-D mesh over every rank of the process group, env axis only.
    `devices`: the mesh's device type ("cuda" or "cpu"), by default the
    group's backend's."""
    from torch.distributed.device_mesh import init_device_mesh
    _need_group("make_env_mesh")
    return init_device_mesh(_device_type(devices), (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def make_train_mesh(n_env: Optional[int] = None, n_model: int = 1,
                    devices: Optional[str] = None):
    """2-D (env, model) mesh for learner configurations that additionally
    shard network state; `n_model=1` degenerates to the env-only layout."""
    from torch.distributed.device_mesh import init_device_mesh
    _need_group("make_train_mesh")
    if n_env is None:
        n_env = dist.get_world_size() // n_model
    return init_device_mesh(_device_type(devices), (n_env, n_model),
                            mesh_dim_names=(ENV_AXIS, MODEL_AXIS))


def env_sharding(mesh, axis_name: str = ENV_AXIS) -> tuple:
    """Placements that split the leading (env) axis of every leaf over the
    mesh's env dimension, replicated over any other."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(0) if name == axis_name else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated_sharding(mesh) -> tuple:
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def shard_of(mesh, axis_name: str = ENV_AXIS) -> Tuple[int, int]:
    """(this rank's index along the mesh's env dimension, that dimension's
    size); (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank(axis_name), mesh.size(mesh.mesh_dim_names.index(axis_name))


def shard_rows(n: int, mesh, axis_name: str = ENV_AXIS) -> slice:
    """This rank's rows of a leading axis of `n` (which the env dimension
    must divide)."""
    index, count = shard_of(mesh, axis_name)
    if n % count != 0:
        raise ValueError(f"num_envs={n} not divisible by {count} env shards")
    local = n // count
    return slice(index * local, (index + 1) * local)


def shard_env_state(es, mesh, axis_name: str = ENV_AXIS):
    """This rank's rows of a batched EnvState (every leaf, the (B, ...)
    snapshot included), cloned."""
    from ..envs.env import map_tensors
    rows = shard_rows(es.steps.shape[0], mesh, axis_name)
    return map_tensors(lambda x: x[rows].clone(), es)


def all_reduce(t: torch.Tensor, mesh, op: str = "sum",
               axis_name: str = ENV_AXIS) -> torch.Tensor:
    """`t` reduced in place over the mesh's env dimension ("sum", "min" or
    "max"), and returned; `t` itself without a mesh."""
    if mesh is not None:
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
                               "max": dist.ReduceOp.MAX}[op],
                        group=mesh.get_group(axis_name))
    return t


def assert_replicated(data: bytes, mesh, what: str, device=None,
                      axis_name: str = ENV_AXIS) -> None:
    """Raise unless `data` (a digest's input) is the same on every rank of
    the mesh's env dimension: one all-reduce of (d, -d) under MAX for a
    56-bit digest d. Nothing without a mesh."""
    if mesh is None:
        return
    d = int.from_bytes(hashlib.blake2b(data, digest_size=7).digest(), "little")
    t = torch.tensor([d, -d], dtype=torch.int64, device=device)
    all_reduce(t, mesh, "max", axis_name)
    if int(t[0]) != -int(t[1]):
        raise RuntimeError(f"{what} differs between the ranks of the env mesh")


def gather_rows(arrays: Sequence, n: int, mesh, device=None,
                axis_name: str = ENV_AXIS) -> list:
    """Every rank's rows of numpy arrays of 4-byte elements (each this
    rank's (n / R, ...) block of a global (n, ...) array), put together on
    every rank, bit for bit: the blocks go zero-padded into one int32 buffer
    that is summed over the env dimension (one all-reduce)."""
    import numpy as np
    rows = shard_rows(n, mesh, axis_name)
    shapes = [(n,) + a.shape[1:] for a in arrays]
    sizes = [int(np.prod(s)) for s in shapes]
    buf = np.zeros(sum(sizes), np.int32)
    at = 0
    for a, shape, size in zip(arrays, shapes, sizes):
        if a.dtype.itemsize != 4:
            raise ValueError(f"gather_rows takes 4-byte elements, not {a.dtype}")
        buf[at:at + size].reshape(shape)[rows] = np.ascontiguousarray(a).view(np.int32)
        at += size
    t = torch.from_numpy(buf).to(device)
    all_reduce(t, mesh, "sum", axis_name)
    out, at = [], 0
    flat = t.cpu().numpy()
    for a, shape, size in zip(arrays, shapes, sizes):
        out.append(flat[at:at + size].reshape(shape).view(a.dtype).copy())
        at += size
    return out
