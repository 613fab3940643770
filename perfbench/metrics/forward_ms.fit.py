"""Device ms a training step of every other operation: the frame under
grad, the loss and the optimizer's step. Read only where the profiler
linked nearly every operation to its launch."""


def read(layers):
    if not layers or layers.get("attributed", 0) < 0.99:
        return None
    v = layers["ms"].get("forward")
    return v if v else None
