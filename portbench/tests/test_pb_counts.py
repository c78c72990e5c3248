"""The operation and byte counts against hand-worked values: the cell's
shapes, and K3's at 1536x1152 under true CFG."""

import pytest

from portbench import manifest
from portbench.counts import attention, step

D = 3072


def test_a_block_is_113m_macs_a_token():
    # q, k, v, out: 4 * 3072^2 = 37,748,736; MLP: 2 * 3072 * 12288 = 75,497,472
    assert step.block_macs_per_token(D, 4.0) == 113_246_208


def test_attention_at_1024_square():
    # S = 64 * 64 image tokens + 512 text tokens = 4608; 4 B H S^2 D
    assert attention.flop(1, 24, 4608, 128) == 260_919_263_232
    # q, k, v, out in bf16, the fp32 lse, K1's two fp32 [S, D] tables
    assert attention.nbytes(1, 24, 4608, 128, tables=True) == (
        4 * 24 * 4608 * 128 * 2 + 4 * 24 * 4608 + 2 * 4608 * 128 * 4)
    t, by = attention.bound_s(1, 24, 4608, 128, tables=True)
    assert by == "operations" and t == pytest.approx(260_919_263_232 / 989e12)


def test_attention_at_1536x1152_cfg():
    # S = (1152 / 16) * (1536 / 16) + 512 = 6912 + 512 = 7424, batch 2 (true CFG)
    assert attention.flop(2, 24, 7424, 128) == 4 * 2 * 24 * 7424 ** 2 * 128 == 1_354_525_310_976
    assert attention.bound_s(2, 24, 7424, 128)[0] == pytest.approx(1.3696e-3, rel=1e-4)


def test_step_flop_t2i_1024():
    cfg = manifest.resolve("t2i-1024-s30")["config"]
    got = step.step_flop(cfg, 1, 4096, 512)
    blocks = 2 * 113_246_208 * 4608 * (57 + 14)          # FLUX 19 + 38, ControlNet 4 + 10
    attn = 260_919_263_232 * (57 + 14)
    heads = 2 * 14 * D * D * 4096                         # the ControlNet's 14 residual heads
    # the rest (modulation, embedders, heads of FLUX) is under 0.2 %
    assert got == pytest.approx(blocks + attn + heads, rel=2e-3)
    assert 9.3e13 < got < 9.5e13
