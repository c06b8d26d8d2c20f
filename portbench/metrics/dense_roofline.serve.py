"""Per-layer metric ``dense_roofline.serve``: the sum of every
``models/layers.py::Dense`` call's roofline bound (max of 2MKN at the bf16
peak and the bytes of x, W, b and y at the peak bandwidth) over the device
time of the kernels those calls launched, in %. The calls are the
benchmark's ``portbench.dense|M|K|N|elem`` ranges (hooks on the module)."""

from portbench import flops


def read(ctx):
    t = ctx.get("trace")
    if t is None or not t.has_device:
        return None
    times = t.range_device_time("portbench.dense|")
    device = sum(v for k, v in times.items() if not k.startswith("#"))
    if device <= 0:
        return None
    bound = 0.0
    for k, n in times.items():
        if k.startswith("#"):
            M, K, N, elem = (int(x) for x in k[1:].split("|")[1:])
            bound += n * flops.dense_bound_s(M, K, N, elem)
    return 100.0 * bound / device
