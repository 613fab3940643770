"""Device operations (kernels, copies, fills) a profiled frame: the eager
frame's launch count, which a CUDA graph would not hide."""


def read(layers):
    if not layers or not layers["launches"]:
        return None
    return layers["launches"] / layers["units"]
