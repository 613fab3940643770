"""Device allocations a training step: the rise of the caching allocator's
`num_device_alloc` and `num_alloc_retries` across the program's
`train.step` span. None without CUDA, or from a program that records no
spans."""
from lumenrenderer_tpu_torch.utils import profiling


def read(layers):
    per_unit = getattr(profiling, "per_unit", None)
    return per_unit and per_unit("device_allocs", "train.step")
