"""The share of listed visits that K1 ran, in percent, over every K1
launch of the profiled frames: 100 x the visits its vote let the tiles run
/ the visits the tiles' lists held, from K1's visit counter, which the
program passes to the frame's own launches while the profiler runs
(`utils/profiling.py` `count_visits`). None from a program that records
no spans or launched no K1."""
from lumenrenderer_tpu_torch.utils import profiling


def read(layers):
    per_unit = getattr(profiling, "per_unit", None)
    listed = per_unit and per_unit("k1_visits_listed")
    if not listed:
        return None
    return 100.0 * per_unit("k1_visits_run") / listed
