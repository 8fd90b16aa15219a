"""95th percentile (nearest rank) of the time of every
``SearchService.search`` call of the window (queue wait, coalescing
window and engine call): a benchmark-side wrapper around the service
handed to ``make_http_server``."""

from perfbench.trace import percentile


def read(obs: dict):
    calls = obs.get("search_ms")
    return percentile(calls, 95) if calls else None
