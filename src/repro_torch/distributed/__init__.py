"""The trainer's fault tolerance (the rest of the distributed layer waits
for ROADMAP queue 1, item 2)."""
from . import fault  # noqa: F401
