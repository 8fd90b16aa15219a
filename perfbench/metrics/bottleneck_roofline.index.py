"""The stride-1 identity bottlenecks' share of their roofline while
indexing: the sum over the traced stretch's block calls of the least
time the chip could take (``work.bottleneck_call_work`` over each call's
valid rows, bounded by ``work.roofline_s``: 165 TFLOP/s or 3.35 TB/s),
over the device time of the kernels launched inside the benchmark's
``perfbench.bottleneck`` spans around those calls."""


def read(obs: dict):
    b = obs.get("bottleneck")
    if not b or not b.get("calls") or not b.get("device_s"):
        return None
    return 100.0 * b["bound_s"] / b["device_s"]
