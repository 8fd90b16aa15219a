"""The general generators, one per kind of traffic.  A traffic mix
(``perfbench/traffic/<mix>.json``) names its ``kind``, and
``drivers/<kind>.py`` runs it: ``run(cell) -> harness.Outcome``."""
