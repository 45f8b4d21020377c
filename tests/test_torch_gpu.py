"""The CUDA kernels against their plain PyTorch versions, on the card.

These run chip_smoke.py's checks (phases 1, 2 and 4) at small sizes, so
the card's checks live in one place.  The kernels have no CPU mode, so
these tests skip without a CUDA device.  This file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

import chip_smoke
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
    before = ktrav.launches
    closest, anyhit = chip_smoke.phase1(sd, ktrav.PacketTables(sd.bvh),
                                        n_rays=4096)
    assert closest["hits"] > 0.2 * closest["rays"]
    assert anyhit["occluded"] > 0
    assert ktrav.launches == before + 2


def test_accum_kernel_matches_plain(cuda):
    before = kacc.launches
    chip_smoke.phase2(5 * 2048 + 17, 8 * 1024)
    assert kacc.launches > before


def test_render_on_card_matches_cpu(cuda):
    assert chip_smoke.phase4() < 0.03
