"""The fp32 kernels' CUDA sources run on the CPU through
``ray_tpu_torch.tools.emulate_ring`` (their threads as OS threads, their
cp.async copies synchronous; built by the host C++ compiler), held
against the plain versions at the tolerances chip_smoke.py holds them to
on the card: K1, K2 and K3 on their ring kernels up to head dim 256
(route fma_f32_ring: each one-slice width, both copy sizes, 64- and
32-row blocks) and on the ring kernels' slices past 256
(dchunk_fma_f32_ring). Ragged lengths, Sq != Sk both ways, causal and
not. Nothing here times a kernel or reads the card's
compiler: chip_smoke.py and tools/check_head_dims.py do that on the card.
"""

import pytest

from ray_tpu_torch.tools import emulate_ring as E


@pytest.fixture(scope="module")
def lib():
    return E.build()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,shape", [
    # head dims: each one-slice width (16, 32, 64, 128, 192, 256), 4-byte
    # copies at odd D; (B, Sq, Sk, H)
    (1, (1, 150, 130, 2)),
    (16, (2, 130, 200, 2)),     # ModelConfig.debug's head dim, Sq < Sk
    (30, (1, 100, 120, 2)),     # the 32-column width, 4-byte copies
    (33, (1, 150, 130, 2)),
    (64, (1, 200, 65, 3)),      # Sq > Sk by more than a tile
    (97, (1, 130, 150, 2)),     # the 128-column width, 4-byte copies
    (128, (1, 150, 130, 2)),    # 64-row K1/K2 blocks, 32-row K3 ones
    (161, (1, 100, 100, 1)),
    (255, (1, 70, 150, 2)),
    (256, (1, 150, 130, 2)),
    # past 256: the slices
    (257, (1, 100, 90, 2)),
    (320, (1, 150, 130, 1)),
])
def test_fp32_kernels_match_the_plain_versions(lib, d, shape, causal):
    b, sq, sk, h = shape
    row = E.check(lib, d, b=b, sq=sq, sk=sk, h=h, causal=causal)
    assert row["agree"], row


def test_translation_leaves_no_device_construct():
    """Every asm statement, launch and dynamic shared-memory declaration of
    the emulated sources has a hook; an unknown asm raises."""
    for name in (*E.SOURCES, *E.HEADERS):
        text = E.translate((E._CSRC / name).read_text())
        assert "asm volatile" not in text and "<<<" not in text
    with pytest.raises(ValueError):
        E.translate('asm volatile("trap;\\n");')
