"""tyrant_tpu_torch — the wavefront path tracer of ``tyrant_tpu`` in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The JAX package ``tyrant_tpu`` is the reference.  This package imports
nothing of it and never imports ``jax``: it keeps its own copies of the
framework-free host modules (``config``, ``scene.bvh``, ``scene.procgen``,
the scene loaders ``scene.ply``/``obj``/``stl``/``gltf``/``description``
with ``scene.instancing``, ``scene.texture`` and ``utils``, and
``native``) and ports the rest.

Device rule: every function takes its device from its tensors (or from an
explicit ``device`` argument, "cuda" by default where a public entry point
takes one).  CUDA tensors go through the hand-written kernels in
:mod:`tyrant_tpu_torch.ops.kernels`; CPU tensors go through their plain
PyTorch versions.  Without a CUDA device, "cuda" raises; nothing falls
back to the CPU.
"""

from .device import require_cuda  # noqa: F401

__version__ = "0.1.0"
