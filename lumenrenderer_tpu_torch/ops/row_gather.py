"""The row gather under grad, whose backward is a hand-written scatter-add.

`gather_rows(table, idx)` returns `table[idx]` for a (T, C) table and
integer `idx` of any shape (each entry in [0, T); the callers clamp, and
nothing here reads the device to check). Without grad (grad mode off, or a
table that needs none) it is exactly `table[idx]`, with no autograd node.
Under grad it is an autograd op whose forward is the same `table[idx]` and
which saves only the flattened indices and T; its backward, out (T, C) =
zeros then out[idx[e]] += grad[e] for every entry e, is
`gather_rows_backward`.

On a CUDA tensor the backward launches `csrc/row_scatter.cu` (float32 only)
or raises; PyTorch's own backward of `table[idx]` sorts the indices and
walks each run of equal rows serially on one warp, which is slow where a
few rows take most entries, as a room's large triangles take most rays.
On a CPU tensor it runs `gather_rows_backward_ref`, the plain twin
(`index_add_`). The JAX package has no kernel here: XLA compiles the
gather's transpose into a scatter-add of its own.

The kernel (csrc/row_scatter.cu has the design and its launch shape):
warps that merge equal rows of 32 consecutive entries (and carry a row
across them) before one global reduction a row, on 16-byte column vectors
where C % 4 == 0 and the gradient is 16-byte aligned, else on floats.
While spans record (`utils/profiling.py`), each backward charges the
entries it scattered and the global row updates it issued to the innermost
span (`count_row_scatter`; the twin reports updates = entries).
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import profiling
from . import build

# launches of the CUDA kernel by column vector (the CPU twin does not count)
LAUNCHES = {"float4": 0, "float": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def gather_rows_backward_ref(grad: torch.Tensor, idx: torch.Tensor,
                             rows: int) -> torch.Tensor:
    """Plain PyTorch twin: (rows, C) zeros with grad[e] added into row
    idx[e] for every entry e (grad (N, C), idx (N,))."""
    return torch.zeros((rows, grad.shape[1]), dtype=grad.dtype,
                       device=grad.device).index_add_(0, idx, grad)


def gather_rows_backward(grad: torch.Tensor, idx: torch.Tensor,
                         rows: int) -> torch.Tensor:
    """The (rows, C) gradient of a (rows, C) table gathered at idx (N,)
    int32 or int64, given grad (N, C) of the gathered rows: the twin on a
    CPU tensor, the kernel on a CUDA tensor (float32; raises otherwise).
    Reads nothing from the device."""
    n = idx.shape[0]
    if grad.dim() != 2 or grad.shape[0] != n:
        raise ValueError(f"grad {tuple(grad.shape)} must be ({n}, C)")
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx must be int32 or int64, not {idx.dtype}")
    recording = profiling.is_recording()
    if grad.device.type == "cpu":
        out = gather_rows_backward_ref(grad, idx, rows)
        if recording:
            profiling.count_row_scatter(torch.tensor([n, n]))
        return out
    if grad.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cpu or cuda, not {grad.device}")
    dev = grad.device
    c = grad.shape[1]
    grad = grad.contiguous()
    idx = idx.contiguous()
    build.check_tensors(dev, {"grad": (grad, torch.float32, (n, c)),
                              "idx": (idx, idx.dtype, (n,))})
    out = torch.zeros((rows, c), dtype=torch.float32, device=dev)
    counter = (torch.zeros(2, dtype=torch.int64, device=dev) if recording
               else None)
    if n and c:
        vec = c % 4 == 0 and grad.data_ptr() % 16 == 0
        fn = build.load_function(
            "row_scatter", "row_scatter_launch",
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p])
        build.launch(fn, dev, grad.data_ptr(), idx.data_ptr(),
                     int(idx.dtype == torch.int64), out.data_ptr(),
                     None if counter is None else counter.data_ptr(), n, c,
                     int(vec))
        LAUNCHES["float4" if vec else "float"] += 1
    if counter is not None:
        profiling.count_row_scatter(counter)
    return out


class _GatherRows(torch.autograd.Function):
    """table[idx], saving only the flattened indices and the table's shape;
    the backward is `gather_rows_backward`."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.rows, ctx.cols = table.shape
        ctx.save_for_backward(idx.reshape(-1))
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        return (gather_rows_backward(grad.reshape(idx.shape[0], ctx.cols),
                                     idx, ctx.rows), None)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a (T, C) table and integer idx of any shape, each
    entry in [0, T): `table[idx]` itself without grad, else the autograd op
    whose backward is the row scatter-add (module docstring)."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table[idx]
    if table.dim() != 2:
        raise ValueError(f"gather_rows takes a (T, C) table, not "
                         f"{tuple(table.shape)}")
    return _GatherRows.apply(table, idx)
