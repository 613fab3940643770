"""K1's share of its roofline on this cell's primary, sorted bounce and
sorted shadow passes, in percent: the sum of each pass's least time
(`perfbench.roofline.bound_s` of the operations its visit counter counts
and the bytes of its inputs and output) over the sum of its times (CUDA
events). Absent where the counter disagreed with the replay of its vote."""


def read(layers):
    k1 = (layers or {}).get("k1")
    if not k1 or k1["time_s"] <= 0:
        return None
    return 100.0 * k1["bound_s"] / k1["time_s"]
