"""``fps`` of the interactive preset under a bound of its own: its host
sets the pace, and its rate spreads wider than a device-bound cell's."""

from perfbench.end_to_end.fps import read  # noqa: F401
