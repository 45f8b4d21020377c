"""The benchmark's scene generators, one module a scene, found by the name
a configuration file gives under ``scene.generator`` (default
``terrain_spheres``).

A generator has ``make(scene: dict) -> dict``: it takes the configuration's
``scene`` object (with the CPU tests' small-size overrides applied) and
returns the keyword arguments of the program's ``Scene.from_triangles``
(``v0``, ``v1``, ``v2``, ``spheres`` and any other that function takes) as
numpy arrays and the program's dataclasses, made from the configuration
alone.  The harness adds the configuration's ``builder``, and hands the
same dictionary to the configuration's plain reference
(``perfbench/reference/<name>.py``, ``make_step``), which works out from it
what it needs.
"""
