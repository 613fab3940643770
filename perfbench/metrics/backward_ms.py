"""Device ms a training step of the operations launched under the autograd
engine's ranges: the backward of the frame, its recompute under remat
included. Read only where the profiler linked nearly every operation to
its launch."""


def read(layers):
    if not layers or layers.get("attributed", 0) < 0.99:
        return None
    v = layers["ms"].get("backward")
    return v if v else None
