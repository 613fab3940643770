"""Device ms a frame of kernel K1 (operations whose name holds
`visit_scan_kernel`)."""


def read(layers):
    if not layers:
        return None
    v = layers["ms"].get("k1")
    return v if v else None
