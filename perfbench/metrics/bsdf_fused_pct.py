"""The share of the Disney BSDF's rays that kernel D shaded, in percent,
over the profiled frames: 100 x `bsdf_fused_rays` / `bsdf_rays`, the
program's host counts of each call of `sample` or `evaluate`
(`bsdf/disney.py`, charged while the profiler runs). 100 where every call
ran the fused kernel, 0 where every call ran the eager torch code. None
from a program that has no such counter or made no call."""
from lumenrenderer_tpu_torch.utils import profiling


def read(layers):
    rows = profiling.span_table()["spans"].values()
    rays = sum(r.get("bsdf_rays") or 0 for r in rows)
    if not rays:
        return None
    return 100.0 * sum(r.get("bsdf_fused_rays") or 0 for r in rows) / rays
