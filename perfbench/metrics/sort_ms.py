"""Device ms a frame of the ray sort: the self device ms of the program's
`accel.sort` spans (`accel/sorting.py`: key, argsort, gathers, inverse),
less the intersector query they enclose. A CUDA-event window on the
device clock from the span's start to its end, so the host's pace is in
it: idle device time inside the span counts, as it does not in
`accel_ms`. None without CUDA events, or from a program that records no
spans."""
from lumenrenderer_tpu_torch.utils import profiling


def read(layers):
    per_unit = getattr(profiling, "per_unit", None)
    return per_unit and per_unit("device_self_ms", "accel.sort")
