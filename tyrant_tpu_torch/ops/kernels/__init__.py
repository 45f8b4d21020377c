"""Hand-written CUDA kernels and their plain PyTorch versions.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes
the plain version only for CPU tensors.  Each counts its kernel launches
in a plain integer attribute, ``launches``, so a run can show that it went
through the kernel."""
