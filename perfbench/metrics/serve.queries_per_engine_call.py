"""Queries per engine call over the window: the deltas of the service's
own ``stats()`` counters ``queries`` and ``engine_calls``."""


def read(obs: dict):
    calls = obs.get("engine_calls")
    return obs["queries"] / calls if calls else None
