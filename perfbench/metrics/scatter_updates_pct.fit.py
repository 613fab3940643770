"""Global row updates the row gathers' backward issued, in percent of the
entries it scattered, over the profiled training steps: 100 x
`row_scatter_updates` / `row_scatter_rows`, the program's counter of the
row scatter-add (`ops/row_gather.py`, charged while the profiler runs),
summed over every row gather of the step: the attribute tables on the
global path, the light rows, packed materials and emissive on the shared
path. How much merging equal rows within a warp, and the shared-memory
path, save; lower is better. None from a program that has no such counter
or scattered nothing."""
from lumenrenderer_tpu_torch.utils import profiling


def read(layers):
    rows = profiling.span_table()["spans"].values()
    scattered = sum(r.get("row_scatter_rows") or 0 for r in rows)
    if not scattered:
        return None
    return 100.0 * sum(r.get("row_scatter_updates") or 0
                       for r in rows) / scattered
