"""Host syncs a training step: the times the program made the host wait
for the device inside `train.step` (sync debug mode's implicit waits and
the program's own `synchronize`), from the program's `host_syncs`
counter. None from a program that records no spans."""
from lumenrenderer_tpu_torch.utils import profiling


def read(layers):
    per_unit = getattr(profiling, "per_unit", None)
    return per_unit and per_unit("host_syncs")
