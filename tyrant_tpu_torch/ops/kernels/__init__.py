"""Hand-written CUDA kernels and their plain PyTorch versions.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes
the plain version only for CPU tensors.  Each counts its kernel launches
in a plain integer attribute, ``launches``, so a run can show that it went
through the kernel."""

# the launch counters, by name: (module, attribute)
_COUNTERS = {"traverse": ("traverse", "launches"),
             "traverse_wave": ("traverse", "launches_wave"),
             "traverse_normals": ("traverse", "launches_normals"),
             "traverse_wave_normals": ("traverse", "launches_wave_normals"),
             "accumulate": ("accum", "launches"),
             "accumulate_moment2": ("accum", "launches_moment2"),
             "stream": ("stream", "launches"),
             "shade": ("shade", "launches"),
             "shade_surface": ("shade", "launches_surface"),
             "shade_textured": ("shade", "launches_textured"),
             "spheres_closest": ("spheres", "launches_closest"),
             "spheres_any": ("spheres", "launches_any")}


def _module(name: str):
    import importlib
    return importlib.import_module(f"{__name__}.{name}")


def launch_counts() -> dict[str, int]:
    """Every wrapper's launch counter, by name."""
    return {k: getattr(_module(m), a) for k, (m, a) in _COUNTERS.items()}


def set_launch_counts(counts: dict[str, int]) -> None:
    """Set the named counters (0 resets them)."""
    for k, v in counts.items():
        m, a = _COUNTERS[k]
        setattr(_module(m), a, v)
