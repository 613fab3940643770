"""Device ms a frame of ReSTIR DI's own tensor work: the self device ms of
the program's `restir.*` spans (`restir/di.py`: the light CDF and bags,
RIS, the visibility passes' own work, temporal and spatial reuse,
shading), less the occlusion queries the visibility spans hold. CUDA-event
windows on the device clock, so the host's pace is in them: idle device
time inside the spans counts. None without CUDA events, or from a program
that records no ReSTIR spans."""
from lumenrenderer_tpu_torch.utils import profiling


def read(layers):
    per_unit = getattr(profiling, "per_unit", None)
    return per_unit and per_unit("device_self_ms",
                                 lambda k: k.startswith("restir."))
