"""Device ms a frame of the operations launched outside the accel ranges:
the integrator (`integrator/`, `bsdf/`), the accumulation and the rest of
the frame. Read only where the profiler linked nearly every operation to
its launch."""


def read(layers):
    if not layers or layers.get("attributed", 0) < 0.99:
        return None
    return layers["ms"].get("integrator", 0.0)
