"""Device ms a training step of remat's recompute: the inclusive device ms
of the program's `wavefront.*` spans opened in the backward pass (depths
1-4 of `integrator/wavefront.py` run again under
`torch.utils.checkpoint`). CUDA-event windows on the device clock from
each span's start to its end, so the host's pace is in them: idle device
time inside the spans counts, and the host's waits there lengthen it.
None without CUDA events, or from a program that records no spans."""
from lumenrenderer_tpu_torch.utils import profiling


def read(layers):
    per_unit = getattr(profiling, "per_unit", None)
    return per_unit and per_unit(
        "device_ms",
        lambda k: k.startswith("wavefront.") and k.endswith("/backward"))
