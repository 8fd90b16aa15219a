"""What the drivers share: the port's model under the benchmark's
weights, benchmark-side spans around its identity blocks, memory."""

from __future__ import annotations

import gc

import torch

from perfbench import work

__all__ = ["BlockSpans", "free", "memory_peak", "port_model"]


def port_model(cfg: dict, weights: dict, device, **overrides):
    """The port's registry model ``cfg["model"]`` holding ``weights``
    (strict: every name and shape must match), in eval mode on
    ``device``.  It is built on the meta device and filled from the
    weights, so no host-side initialization runs."""
    from research_image_retrieval_tpu_torch.models.registry import get_model

    with torch.device("meta"):
        model = get_model(cfg["model"], backbone_name=cfg["arch"],
                          outputdim=cfg["outputdim"], p=cfg["gem_p"],
                          s=cfg["arcface_s"], m=cfg["arcface_m"],
                          num_classes=cfg["num_classes"], dtype=cfg["dtype"],
                          **overrides)
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model.eval()


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


class BlockSpans:
    """``record_function("perfbench.bottleneck")`` around every stride-1
    identity bottleneck of a ResNet (each stage's blocks after its first,
    by their torchvision names), so whatever implements the block is
    timed by the device time of the kernels launched inside the span;
    while ``stretch`` is active each call's input shape and extents are
    kept to count its work after the stretch."""

    def __init__(self, model, cfg: dict, stretch, prefix="backbone."):
        self.stretch = stretch
        self.calls: list = []
        for s, (depth, width) in enumerate(zip(cfg["depths"], cfg["widths"])):
            for b in range(1, depth):
                block = model.get_submodule(f"{prefix}layer{s + 1}.{b}")
                block.forward = self._wrap(block.forward,
                                           cfg["expansion"] * width)

    def _wrap(self, forward, channels: int):
        def wrapped(x, *args, **kwargs):
            if self.stretch.active:
                ext = kwargs.get("extents", args[0] if args else None)
                self.calls.append((channels, tuple(x.shape), ext))
            with torch.profiler.record_function("perfbench.bottleneck"):
                return forward(x, *args, **kwargs)
        return wrapped

    def work(self) -> tuple[float, float, int]:
        """(operations, roofline seconds, calls) of the calls made while
        the stretch was active: three convolutions over each image's
        valid rows, bounded by ``work.roofline_s``."""
        ops = bound = 0.0
        for channels, shape, ext in self.calls:
            hw = shape[2:4] if shape[1] == channels else shape[1:3]
            e = ext.detach().to("cpu", torch.int64)
            rows = int((e[:, 0].clamp(max=hw[0])
                        * e[:, 1].clamp(max=hw[1])).sum())
            o, nbytes = work.bottleneck_call_work(rows, channels)
            ops += o
            bound += work.roofline_s(o, nbytes)
        return ops, bound, len(self.calls)
