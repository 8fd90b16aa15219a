"""The ViT model's share of the chip's fp32-accurate peak while
indexing: the operations of every extraction call the traced stretch
launched (``work_vit.vit_ops`` at each image's own snapped extents per
scale, not the padded bucket) over the stretch's length and
``work.PEAKS["fp32_tc"]`` (165 TFLOP/s)."""

from perfbench.work import PEAKS


def read(obs: dict):
    t = obs.get("trace")
    if not t or not obs.get("stretch_ops"):
        return None
    return 100.0 * obs["stretch_ops"] / (t["window_s"] * PEAKS["fp32_tc"])
