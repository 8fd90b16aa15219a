"""CPU tests of the benchmark; the card-only cases carry the ``cuda`` marker."""
