"""The yardstick's arithmetic against a hand count at one small shape."""
import pytest

from perfbench import cost, harness

M = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
     "d_head": 4, "d_ff": 16, "vocab_size": 32}


def test_flops_by_hand():
    # attention 8 * (8 + 8) + 8 * 8, SwiGLU 3 * 8 * 16
    assert cost.layer_weights(M) == 576
    # 2 layers x 2 x 576, 4 H dh a pair x 3 pairs x 2 layers, logits 2 V D
    assert cost.token_flops(M, 3, True) == 2304 + 192 + 512
    # chunk of 2 tokens from position 4: pairs 5 + 6 = 11
    assert cost.chunk_flops(M, 4, 2) == 4608 + 4 * 2 * 2 * 4 * 11 + 512
    assert cost.kv_bytes_per_token(M) == 2 * 2 * 1 * 4 * 2


def test_moe_layer_weights_count_top_k_experts():
    moe = dict(M, n_experts=4, top_k=2)
    assert cost.layer_weights(moe) == 8 * 16 + 8 * 8 + 8 * 4 + \
        2 * 3 * 8 * 16
    assert cost.param_count(moe) == 2 * (128 + 64 + 4 * 384 + 32 + 16) \
        + 2 * 32 * 8 + 8


def test_kernel_bounds_by_hand():
    # contexts 3 and 5: 8 positions x K dh x (k, v) x 2 bytes, q + o (f32)
    # and m, l for 2 rows; 4 H dh a pair
    want = max(256 / cost.PEAK_FLOPS,
               (128 + 2 * (2 * 2 * 4 * 4 + 2 * 2 * 4)) / cost.HBM_BW)
    assert cost.paged_attention_bound(M, [3, 5]) == pytest.approx(want)
    # a shared prefix of 2 positions read once
    assert cost.paged_attention_bound(M, [3, 5], 2) < \
        cost.paged_attention_bound(M, [3, 5])
    # 3 rows, 8 -> 16: codes 64 B, scales 64 B, x 3 x 16 B, y 3 x 64 B
    assert cost.quant_gemv_bound(3, 8, 16) == pytest.approx(
        max(768 / cost.PEAK_FLOPS, 368 / cost.HBM_BW))


def _run(steps, window=1.0, wbytes=1000.0):
    return harness.Run(M, {}, 2, 0.0, window, 0.0, steps, {}, [], wbytes)


def test_mfu_and_hbm_share_by_hand():
    mfu = harness.load_reader("mfu")
    hbm = harness.load_reader("hbm_share")
    steps = [harness.StepRec(0, 1, [(3, -1, 0)], [(0, 2)], 2)]
    run = _run(steps)
    flops = (2 * 2 * 576 * 2 + 4 * 2 * 2 * 4 * 3 + 512) + 3008
    assert mfu(run) == pytest.approx(100 * flops / cost.PEAK_FLOPS)
    embed = 4 * 32 * 8
    chunk_b = 1000 - embed + 4 * 8 * 2 + 32 * 2
    decode_b = 1000 - embed + 4 * 8 * 1 + 32 * (3 + 1)
    assert hbm(run) == pytest.approx(100 * (chunk_b + decode_b) / cost.HBM_BW)


def test_shared_tokens_count_each_document_once():
    rows = [(20, 0, 16), (18, 0, 16), (30, 1, 16), (5, -1, 0)]
    assert harness.shared_tokens(rows) == 16
