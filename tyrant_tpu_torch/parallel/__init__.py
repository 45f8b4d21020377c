"""The strip-parallel path: one row strip of the image a device."""

from .sharded import (ShardedRenderer, assemble_image,  # noqa: F401
                      init_sharded_state, make_mesh, make_sharded_step)
