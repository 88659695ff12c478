"""The FLOP and byte counters against hand counts at the published widths."""

import pytest

from benchmark.harness import Cell
from benchmark.metrics import counters


@pytest.fixture(scope="module")
def c():
    return Cell("cv3.datagen_b16").config


def test_peaks_and_bound():
    assert counters.bound(3.35e12, 0) == (1e3, "bytes")
    assert counters.bound(0, 989e12) == (1e3, "operations")
    assert counters.bound_f32(0, 67e12) == (1e3, "operations")


def test_qwen_token_flops(c):
    layer = 896 * 1152 + 896 * 896 + 3 * 896 * 4864  # q/k/v (14 + 2 + 2 heads of 64), o, gate/up/down
    assert counters.qwen_token_flops(c) == 2 * (24 * layer + 896 * 6761) == 727_768_832
    assert counters.qwen_attention_flops(c, 10) == 4 * 24 * 14 * 64 * 10
    assert counters.lm_sequence_flops(c, 3, 2) == 5 * 727_768_832 + 4 * 24 * 14 * 64 * 15


def test_decode_attention_work():
    nbytes, flops = counters.decode_attention_work(16, 512, 14, 2, 64, 3200)
    assert nbytes == 57_344 + 16_384 + 1_638_400 + 32_768 + 64
    assert flops == 4 * 14 * 64 * 3200


def test_flash_attention_work():
    assert counters.flash_attention_pairs([3], 4, 0) == 12
    assert counters.flash_attention_pairs([3], 4, 2) == 2 + 2 + 3 + 3
    assert counters.flash_attention_pairs([4, 2], 4, 2) == (2 + 2 + 4 + 4) + (2 + 2 + 2 + 2)
    nbytes, flops = counters.flash_attention_work([100, 50], 128, 16, 64, 0)
    assert nbytes == 2 * 2 * 16 * 128 * 64 * 2 + 150 * 16 * 64 * 2 * 2 + 8
    assert flops == 4 * 64 * 16 * (128 * 100 + 128 * 50)


def test_int4_matmul_work():
    assert counters.int4_matmul_work(4, 896, 9728) == (4 * 896 * 2 + 896 * 9728 // 2 + 9728 * 4 + 4 * 9728 * 2,
                                                       2 * 4 * 896 * 9728)


def test_dit_flops(c):
    block = 1024 * 3072 + 1024 * 1024 + 2 * 1024 * 2048
    conv = 2 * 1024 * 64 * 31
    assert counters.dit_frame_flops(c["flow"]["dit"]) == 2 * (320 * 1024 + conv + 22 * block + 1024 * 80) == 378_044_416
    att = 4 * 22 * 16 * 64 * 100 * 100
    assert counters.dit_solve_flops(c["flow"], 100) == 10 * 2 * (378_044_416 * 100 + att)


def test_causal_hift_flops(c):
    f0 = 2 * (80 * 512 * 4 + 4 * 512 * 512 * 3 + 512)
    pre = 2 * 80 * 512 * 5
    s0 = 2 * 8 * (512 * 256 * 16 + 18 * 256 * 30 + 3 * 2 * 256 * 256 * 7 + 3 * 2 * 256 * 256 * (3 + 7 + 11))
    s1 = 2 * 40 * (256 * 128 * 11 + 18 * 128 * 6 + 3 * 2 * 128 * 128 * 7 + 3 * 2 * 128 * 128 * (3 + 7 + 11))
    s2 = 2 * 120 * (128 * 64 * 7 + 18 * 64 * 1 + 3 * 2 * 64 * 64 * 11 + 3 * 2 * 64 * 64 * (3 + 7 + 11))
    post = 2 * 120 * 64 * 18 * 7
    assert counters.causal_hift_frame_flops(c["hift"]) == f0 + pre + s0 + s1 + s2 + post


@pytest.fixture(scope="module")
def c2():
    return Cell("cv2.stream_c8").config


def test_unet_flops(c2):
    f = c2["flow"]
    tb = 256 * 512 * 3 + 512 * 256 + 256 * 1024 + 1024 * 256  # to_q/k/v, to_out, ff_in, ff_out
    down = 320 * 256 * 3 + 256 * 256 * 3 + 320 * 256 + 4 * tb  # block1, block2, res, 4 transformer blocks
    mid = 256 * 256 * 3 + 256 * 256 * 3 + 256 * 256 + 4 * tb
    up = 512 * 256 * 3 + 256 * 256 * 3 + 512 * 256 + 4 * tb
    tail = 256 * 256 * 3 + 256 * 256 * 3 + 256 * 256 * 3 + 256 * 80  # down_conv, up_conv, final block, final proj
    per_frame = 2 * (down + 12 * mid + up + tail)
    assert counters.unet_frame_flops(f) == per_frame == 132_161_536
    att = 4 * 4 * 14 * 8 * 64 * 100 * 100  # 4 blocks at each of 14 levels, QK and PV, full attention
    assert counters.unet_solve_flops(f, 100) == 10 * 2 * (per_frame * 100 + att)


def test_conformer_flops(c2):
    f = c2["flow"]
    d, ffn = 512, 2048
    assert counters.conformer_layer_flops(d, ffn, 10, 60) == 2 * (10 * (4 * d * d + 2 * d * ffn) + 19 * d * d + 3 * d * 60)
    t = 10
    embed_pre = 2 * t * (d * d + d * d * 4 + d * d * 3)
    layers = 6 * counters.conformer_layer_flops(d, ffn, t, t * t)
    up = 2 * 2 * t * (d * d * 5 + d * d) + 4 * counters.conformer_layer_flops(d, ffn, 2 * t, 4 * t * t)
    assert counters.upsample_encoder_flops(f, t) == embed_pre + layers + up + 2 * 2 * t * d * 80


def test_hift_flops(c2):
    h = c2["hift"]
    f0 = 2 * (80 * 512 * 3 + 4 * 512 * 512 * 3 + 512)
    pre = 2 * 80 * 512 * 7
    s0 = 2 * 8 * (512 * 256 * 16 // 8 + 18 * 256 * 30 + 3 * 2 * 256 * 256 * 7 + 3 * 2 * 256 * 256 * 21)
    s1 = 2 * 40 * (256 * 128 * 11 // 5 + 18 * 128 * 6 + 3 * 2 * 128 * 128 * 7 + 3 * 2 * 128 * 128 * 21)
    s2 = 2 * 120 * (128 * 64 * 7 // 3 + 18 * 64 + 3 * 2 * 64 * 64 * 11 + 3 * 2 * 64 * 64 * 21)
    post = 2 * 120 * 64 * 18 * 7
    assert counters.hift_frame_flops(h) == pytest.approx(f0 + pre + s0 + s1 + s2 + post, rel=1e-6)
