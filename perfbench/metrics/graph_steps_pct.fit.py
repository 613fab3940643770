"""Training steps run by replaying the captured step, in percent of the
profiled steps: 100 x the program's `graph_replays` counter (charged to
the `train.step` unit, one a replay) / the `train.step` calls. 100 where
every profiled step replays one CUDA graph, 0 where every step runs
eagerly. None in an untraced run, and from a program that has no such
counter."""
from lumenrenderer_tpu_torch.utils import profiling


def read(layers):
    if not layers:
        return None
    row = profiling.span_table()["spans"].get("train.step")
    if not row or not row["calls"] or "graph_replays" not in row:
        return None
    return 100.0 * row["graph_replays"] / row["calls"]
