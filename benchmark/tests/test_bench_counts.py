"""The counts and peaks of ``benchmark/counts.py`` against hand sums at the
cells' shapes."""
import pytest

from benchmark import counts

B, S, H, D, W, FFN = 64, 1024, 8, 32, 256, 1024


def test_peaks_take_tf32_for_fp32():
    assert counts.peak_flops("float32") == 495e12
    assert counts.peak_flops("bfloat16") == 989e12
    assert counts.PEAK_BYTES == 3.35e12
    assert counts.PEAK_EXP2 == pytest.approx(16 * 132 * 1.98e9)


def test_attention_at_the_fx_cell():
    f = counts.attention_forward(B, S, H, D, "float32")
    assert f.flops == 4 * 64 * 8 * 1024 ** 2 * 32 == 68_719_476_736
    assert f.nbytes == 4 * (64 * 1024 * 8 * 32) * 4 == 268_435_456
    assert f.exps == 64 * 8 * 1024 ** 2
    # Bound by the products at the TF32 peak: 68.7 GFLOP / 495 TFLOP/s.
    assert counts.bound_s(f.flops, f.nbytes, "float32", f.exps) == pytest.approx(
        68_719_476_736 / 495e12)
    b = counts.attention_backward(B, S, H, D, "float32")
    assert b.flops == 2.5 * f.flops
    assert b.nbytes == 8 * (64 * 1024 * 8 * 32) * 4 + 4 * 64 * 8 * 1024
    # bf16: the exponentials bind (536.9 M / 4.18 T a second).
    fb = counts.attention_forward(B, S, H, D, "bfloat16")
    assert counts.bound_s(fb.flops, fb.nbytes, "bfloat16", fb.exps) == pytest.approx(
        64 * 8 * 1024 ** 2 / (16 * 132 * 1.98e9))


def test_one_reduce():
    e = 28_000
    w = counts.reduce_forward(B, 8192, 4096, e, 64, "float32")
    assert w.flops == 2 * 64 * e * 64
    assert w.nbytes == 4 * (64 * 8192 * 64 + e * 64 + 64 * 4096 * 64) + 4 * e
    assert counts.bound_s(w.flops, w.nbytes, "float32") == pytest.approx(w.nbytes / 3.35e12)


def _shapes(layers, batch=B):
    return counts.ModelShapes(batch=batch, nodes=8192, latent=4096, cin=1, cout=1, lift=64,
                              hidden=64, mlp_layers=3, coord_dim=2, tokens=S, width=W,
                              heads=H, ffn=FFN, layers=layers, dtype="float32")


def test_one_uvit_layer():
    r = B * S
    u = counts.uvit_forward(_shapes(1))
    # patch_linear, q/k/v/o, w1 and w3, w2; no long skip with one layer.
    assert u["products"].flops == 2 * r * W * W + 4 * 2 * r * W * W + 3 * 2 * r * W * FFN
    assert u["attention"].flops == 4 * B * H * S * S * (W // H)


def test_three_layers_add_one_skip_and_the_step_is_three_forwards():
    one, three = counts.uvit_forward(_shapes(1)), counts.uvit_forward(_shapes(3))
    r = B * S
    per = 4 * 2 * r * W * W + 3 * 2 * r * W * FFN
    assert three["products"].flops == one["products"].flops + 2 * per + 2 * r * 2 * W * W
    m = _shapes(3)
    fwd = counts.forward_flops(m, 28_000, 28_000, True)
    att = three["attention"].flops
    assert counts.step_flops(m, 28_000, 28_000, True) == pytest.approx(
        3 * (fwd - att) + 3.5 * att)
    # About 0.64 TFLOP a forward at the fx cell, the UViT most of it.
    assert 0.6e12 < fwd < 0.7e12
