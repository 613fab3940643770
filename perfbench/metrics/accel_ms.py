"""Device ms a frame of the operations launched inside the accel ranges
(`accel/`: the ray sort, tile culling, visit lists, the decode), K1
excepted. Read only where the profiler linked nearly every operation to
its launch."""


def read(layers):
    if not layers or layers.get("attributed", 0) < 0.99:
        return None
    v = layers["ms"].get("accel")
    return v if v else None
