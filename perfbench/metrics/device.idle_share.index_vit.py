"""The device's idle share over the traced stretch of the ViT index
cell's window: 1 minus the union of the intervals in which any device
operation ran, over the stretch's length (``trace.Stretch``)."""

from perfbench.trace import idle_share_pct


def read(obs: dict):
    return idle_share_pct(obs)
