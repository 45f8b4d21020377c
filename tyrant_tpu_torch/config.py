"""The render configuration, shared with the JAX package.

``tyrant_tpu.config`` holds plain dataclasses and constants and imports no
framework, so the port uses it as is; this module re-exports the names a
caller of the port needs.
"""

from tyrant_tpu.config import RenderConfig, SkyConfig, small_config  # noqa: F401
