"""Helpers of the port: PFM and OpenEXR readers and writers (copies of
the JAX package's, used by ``scene.texture.load_texture`` and the CLI's
HDR export), render metrics (:mod:`.metrics`) and profiling
(:mod:`.profiling`)."""
