"""Image IO helpers of the port: PFM and OpenEXR readers and writers
(copies of the JAX package's), used by ``scene.texture.load_texture``."""
