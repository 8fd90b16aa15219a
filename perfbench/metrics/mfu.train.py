"""The train step's share of the chip's fp32-accurate peak: the steps
the traced stretch ran, at three times the forward's operations per
image (backbone, whitening and the ArcFace product, counted by
``work.retrieval_macs`` at the step's image size), over the stretch's
length and ``work.PEAKS["fp32_tc"]`` (165 TFLOP/s)."""

from perfbench.work import PEAKS


def read(obs: dict):
    t = obs.get("trace")
    if not t or not obs.get("stretch_ops"):
        return None
    return 100.0 * obs["stretch_ops"] / (t["window_s"] * PEAKS["fp32_tc"])
