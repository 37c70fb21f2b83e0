"""The general loops of the traffic mixes: one per kind of work, each
with ``setup``, ``window``, ``end_to_end``, ``release`` and ``check``."""
