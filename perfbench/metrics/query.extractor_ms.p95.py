"""95th percentile (nearest rank) of the time of every image-extraction
call of the window, lock wait included: a benchmark-side wrapper around
the ``ImageExtractor`` handed to ``make_http_server``."""

from perfbench.trace import percentile


def read(obs: dict):
    calls = obs.get("extractor_ms")
    return percentile(calls, 95) if calls else None
