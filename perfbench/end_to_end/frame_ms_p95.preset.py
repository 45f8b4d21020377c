"""``frame_ms_p95`` of the interactive preset under a bound of its own:
its host sets the pace, and its frames spread wider than a device-bound
cell's."""

from perfbench.end_to_end.frame_ms_p95 import read  # noqa: F401
