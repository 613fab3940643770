"""Device ms a frame of ReSTIR DI's occlusion queries: the device ms of the
spans the program's two `restir.visibility` spans hold (`restir/di.py`'s
visibility passes through the frame's sorted occluder: the ray sort,
culling, K1's any-hit scan), the spans' inclusive ms less their self ms.
CUDA-event windows on the device clock, idle time inside included. None
without CUDA events, or from a program that records no ReSTIR spans."""
from lumenrenderer_tpu_torch.utils import profiling


def read(layers):
    per_unit = getattr(profiling, "per_unit", None)
    total = per_unit and per_unit("device_ms", "restir.visibility")
    if total is None:
        return None
    return total - per_unit("device_self_ms", "restir.visibility")
