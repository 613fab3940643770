"""The share of ReSTIR DI's visibility rays that can change the image, in
percent, over the profiled frames: 100 x `restir_rays_live` /
`restir_rays_sent`, the program's device counter of its two visibility
passes (`restir/di.py`, charged while the profiler runs): the rays of
pixels that hit something and hold a nonzero reservoir weight, over every
ray sent to the occluder (missed pixels' and zero-weight rays are sent
too). None from a program that has no such counter or sent no ray."""
from lumenrenderer_tpu_torch.utils import profiling


def read(layers):
    rows = profiling.span_table()["spans"].values()
    sent = sum(r.get("restir_rays_sent") or 0 for r in rows)
    if not sent:
        return None
    return 100.0 * sum(r.get("restir_rays_live") or 0 for r in rows) / sent
