"""The CUDA kernels against their plain PyTorch versions, on the card.

These run chip_smoke.py's checks (phases 1, 2 and 4, the kernels at the
main path's queues and the denoised display path) at small sizes, so the
card's checks live in one place.  The kernels have no CPU mode, so
these tests skip without a CUDA device.  This file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

import chip_smoke
from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch.config import small_config
from tyrant_tpu_torch.ops.kernels import accum as kacc
from tyrant_tpu_torch.ops.kernels import traverse as ktrav
from tyrant_tpu_torch.scene.procgen import terrain
from tyrant_tpu_torch.scene.scene import Scene

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_traverse_kernel_matches_plain(cuda):
    sd = Scene.from_triangles(*terrain(n_quads=32, towers=3),
                              builder="numpy").to_device(cuda)
    before = ktrav.launches, ktrav.launches_wave
    out = chip_smoke.phase1(sd, ktrav.PacketTables(sd.bvh), n_rays=4096)
    for gen in ("mono", "wave"):
        assert out[gen]["closest"]["hits"] > 0.2 * out[gen]["closest"]["rays"]
        assert out[gen]["any"]["occluded"] > 0
    assert (ktrav.launches, ktrav.launches_wave) == (before[0] + 2,
                                                     before[1] + 2)


def test_accum_kernel_matches_plain(cuda):
    before = kacc.launches
    chip_smoke.phase2(5 * 2048 + 17, 8 * 1024)
    assert kacc.launches > before


def test_render_on_card_matches_cpu(cuda):
    assert chip_smoke.phase4() < 0.03


def test_wave_phases_at_small_size(cuda):
    """The wave kernel against the plain walk on the main path's queues
    (extend, connect, AOV primaries), the denoised display path through
    it, and its display image on the card against the CPU."""
    cfg = small_config(width=96, height=64, num_rays=8192)
    ren = tr.Renderer(Scene.from_triangles(*terrain(n_quads=32, towers=3)),
                      cfg)
    queues = chip_smoke.kernels_at_slice(ren)
    for q in ("extend", "connect", "aov"):
        assert queues[q]["wave"]["mismatches"] == 0
        assert queues[q]["bound_ms"] > 0
    disp = chip_smoke.display_path(
        ren.scene, ren.tables,
        small_config(width=96, height=64, num_rays=8192, denoise="on",
                     bloom_strength=0.1, packet_kernel_mode="wave"), steps=3)
    assert disp["launches"]["traverse_wave"] == 2 * 3 + 1
    assert chip_smoke.phase4(denoise_wave=True) < 0.03
