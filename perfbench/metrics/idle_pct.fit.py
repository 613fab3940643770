"""The device's idle share of the profiled training steps, in percent:
100 x (1 - the seconds in which a device operation ran / the profiled
wall time)."""


def read(layers):
    if not layers or layers.get("wall_s", 0) <= 0 or not layers["launches"]:
        return None
    return 100.0 * (1.0 - layers["busy_s"] / layers["wall_s"])
