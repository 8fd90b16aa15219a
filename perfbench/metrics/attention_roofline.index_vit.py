"""The ViT blocks' attention share of its roofline while indexing: the
sum over the traced stretch's attention calls of the least time the
chip could take (``work_vit.attention_call_work`` over each image's
valid tokens: the four projections and the two products, with the
tokens, weights and biases as the bytes, bounded by ``work.roofline_s``
at 165 TFLOP/s or 3.35 TB/s), over the device time of the kernels
launched inside the benchmark's ``perfbench.attention`` spans around
those calls."""


def read(obs: dict):
    a = obs.get("attention")
    if not a or not a.get("calls") or not a.get("device_s"):
        return None
    return 100.0 * a["bound_s"] / a["device_s"]
