"""Host ms a frame outside the program's own waits: the host ms of the
program's `frame` span (`render/renderer.py`) less the host ms blocked in
`profiling.synchronize` inside it (the frame's closing wait). The frame's
implicit waits (`host_syncs.preview` counts them: camera copies, constants
copied from pageable memory, the overflow read) stay inside, so this is
the host's window with the device's pace in it, not the host's own
enqueue cost. None from a program that records no spans."""
from lumenrenderer_tpu_torch.utils import profiling


def read(layers):
    per_unit = getattr(profiling, "per_unit", None)
    frame = per_unit and per_unit("host_ms", "frame")
    return None if frame is None else frame - per_unit("host_wait_ms")
