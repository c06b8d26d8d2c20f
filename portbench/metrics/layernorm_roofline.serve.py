"""Per-layer metric ``layernorm_roofline.serve``: the sum of every
``models/layers.py::LayerNorm`` call's bound (x read and y written once,
f32 scale and bias read, at the peak bandwidth) over the device time of the
kernels those calls launched, in %. The calls are the benchmark's
``portbench.layernorm|rows|width|in_elem|out_elem`` ranges."""

from portbench import flops


def read(ctx):
    t = ctx.get("trace")
    if t is None or not t.has_device:
        return None
    times = t.range_device_time("portbench.layernorm|")
    device = sum(v for k, v in times.items() if not k.startswith("#"))
    if device <= 0:
        return None
    bound = 0.0
    for k, n in times.items():
        if k.startswith("#"):
            rows, width, e_in, e_out = (int(x) for x in k[1:].split("|")[1:])
            bound += n * flops.layernorm_bound_s(rows, width, e_in, e_out)
    return 100.0 * bound / device
