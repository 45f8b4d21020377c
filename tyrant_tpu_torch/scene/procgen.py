"""Procedural test scenes, shared with the JAX package.

``tyrant_tpu.scene.procgen`` builds triangle soups with numpy and imports
no framework, so the port re-exports it as is.
"""

from tyrant_tpu.scene.procgen import benchmark_scene, terrain  # noqa: F401
