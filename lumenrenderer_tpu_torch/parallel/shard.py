"""Row sharding of the frame over a `torch.distributed` device mesh.

Port of `lumenrenderer_tpu/parallel/shard.py`. JAX shards the pixel axis
over a `jax.sharding.Mesh` and lets GSPMD insert the collectives; here each
rank of a 1-D `DeviceMesh` (one process a device) renders its own band of
height / world rows through `pixel_ids`, and the few collectives are
explicit: the image's all-gather, the scalars' all-reduce, the ReSTIR
halo's neighbour exchange and the training step's gradient all-reduce.

The scene and its accel are replicated: `replicate` broadcasts rank 0's
tensors (the Renderer does this to the scene), and every rank then builds
the same accel from it, since every builder (the SAH builders, the cluster
build, the LBVH's stable sort) is deterministic.

Collectives run on the mesh's process group. A gloo group moves CPU
tensors only, so a CUDA tensor is staged through the host there (two ranks
sharing one card, where NCCL refuses); NCCL moves CUDA tensors directly.
"""
from __future__ import annotations

import dataclasses
import socket
from typing import Any, Tuple

import torch
import torch.distributed as dist

from ..core.struct import TensorStruct

TILE_AXIS = "tiles"


def free_port() -> int:
    """A free TCP port on localhost (for a process group's rendezvous)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_mesh(device_type: str | None = None):
    """The 1-D mesh ("tiles") over every rank of the default process group.
    Without a group, a one-rank group is started first (gloo on the CPU,
    NCCL on CUDA). device_type: "cuda" or "cpu" (default: cuda when
    available)."""
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{free_port()}", world_size=1,
            rank=0)
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(TILE_AXIS,))


def rank_and_size(mesh) -> Tuple[int, int]:
    """(this rank's index on the mesh, the mesh's size)."""
    return mesh.get_local_rank(TILE_AXIS), mesh.size()


def _group(mesh):
    return mesh.get_group(TILE_AXIS)


def row_range(height: int, mesh) -> Tuple[int, int]:
    """[row0, row1) of the frame that this rank renders."""
    rank, world = rank_and_size(mesh)
    if height % world:
        raise ValueError(f"height {height} must divide by the mesh's "
                         f"{world} ranks")
    rows = height // world
    return rank * rows, (rank + 1) * rows


def pixel_ids(width: int, height: int, mesh, *, device) -> torch.Tensor:
    """(width * height / world,) int64 global indices of this rank's
    pixels, row-major, on `device` (required: the frame's device)."""
    r0, r1 = row_range(height, mesh)
    return torch.arange(r0 * width, r1 * width, dtype=torch.int64,
                        device=device)


def _staged(x: torch.Tensor, group) -> torch.Tensor:
    """x where the group's backend can move it (the host for gloo)."""
    if dist.get_backend(group) == "gloo" and x.device.type != "cpu":
        return x.cpu()
    return x


def all_reduce(x: torch.Tensor, mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The all-reduce of x over the mesh, on x's device (x is unchanged)."""
    group = _group(mesh)
    y = _staged(x, group).clone()
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.device)


def gather_pixels(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's rows of x (leading axis: the rank's pixels) in rank
    order: the full frame, on every rank, on x's device."""
    group = _group(mesh)
    world = mesh.size()
    if world == 1:
        return x
    y = _staged(x.contiguous(), group)
    parts = [torch.empty_like(y) for _ in range(world)]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts).to(x.device)


def _broadcast(x: torch.Tensor, group) -> torch.Tensor:
    y = _staged(x.contiguous(), group).clone()
    dist.broadcast(y, group=group, group_src=0)
    return y.to(x.device)


def replicate(tree: Any, mesh) -> Any:
    """Rank 0's copy of a tensor, a dict of tensors or a TensorStruct
    (nested), broadcast to every rank; other leaves pass through."""
    if mesh.size() == 1:
        return tree
    group = _group(mesh)

    def rep(x):
        if isinstance(x, torch.Tensor):
            return _broadcast(x, group)
        if isinstance(x, TensorStruct):
            return dataclasses.replace(x, **{
                f.name: rep(getattr(x, f.name))
                for f in dataclasses.fields(x)})
        if isinstance(x, dict):
            return {k: rep(v) for k, v in x.items()}
        return x

    return rep(tree)


def exchange_rows(img: torch.Tensor, band: int, mesh
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The halo of this rank's rows img (h, ...): (top, bottom), the last
    `band` rows of the rank above and the first `band` rows of the rank
    below, zeros where there is no such rank (the frame's edges)."""
    group = _group(mesh)
    rank, world = rank_and_size(mesh)
    top = torch.zeros_like(img[:band])
    bottom = torch.zeros_like(img[:band])
    if world == 1:
        return top, bottom
    if img.dtype == torch.bool:     # moved as bytes
        top, bottom = exchange_rows(img.to(torch.uint8), band, mesh)
        return top.bool(), bottom.bool()
    send_up = _staged(img[:band].contiguous(), group)
    send_down = _staged(img[img.shape[0] - band:].contiguous(), group)
    recv_top = torch.zeros_like(send_up)
    recv_bottom = torch.zeros_like(send_up)
    ops = []
    peer = lambda r: dist.get_global_rank(group, r)  # noqa: E731
    if rank > 0:
        ops += [dist.P2POp(dist.isend, send_up, peer(rank - 1), group),
                dist.P2POp(dist.irecv, recv_top, peer(rank - 1), group)]
    if rank < world - 1:
        ops += [dist.P2POp(dist.isend, send_down, peer(rank + 1), group),
                dist.P2POp(dist.irecv, recv_bottom, peer(rank + 1), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if rank > 0:
        top = recv_top.to(img.device)
    if rank < world - 1:
        bottom = recv_bottom.to(img.device)
    return top, bottom
