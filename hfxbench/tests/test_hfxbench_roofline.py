"""FLOP and byte counts against hand-computed values at the smoke width,
and the readers over a hand-made run."""

import pytest

from hfxbench import catalog, model, roofline
from hfxbench.harness import Run, Step
from hfxbench.tests.conftest import smoke_config

# the smoke width: 2 layers, d 64, 4 query heads and 2 K/V heads of 16,
# d_ff 128, vocabulary 256, bf16 (2 bytes)
LAYER = 64 * 64 + 2 * 64 * 32 + 64 * 64 + 3 * 64 * 128 + 64 + 2 * 32
BODY, HEAD = 2 * LAYER, 256 * 64
KV_TOKEN = 2 * 2 * 2 * 16 * 2          # K and V, 2 layers, 2 heads of 16
ATTN = 4 * 2 * 4 * 16                  # per key, all layers and heads


def dims():
    """The smoke config's counts, as its family (qwen1_5) gives them."""
    cfg = smoke_config()
    return model.family(cfg).counts(cfg)


def test_dims():
    d = dims()
    assert (d.layer_params, d.body_params, d.head_params) == (36992, BODY,
                                                             HEAD)
    assert d.kv_bytes_per_token == KV_TOKEN == 256
    assert d.attn_flops(7) == ATTN * 7 == 3584


def test_prefill_counts():
    rows = [(0, 10), (5, 3)]            # causal keys: 55 and 15 + 6
    assert roofline.causal_keys(0, 10) == 55
    assert roofline.causal_keys(5, 3) == 21
    assert dims().prefill_flops(rows, 1) == \
        2 * BODY * 13 + ATTN * 76 + 2 * HEAD == 1_995_264
    assert dims().prefill_bytes(rows) == \
        (BODY + HEAD) * 2 + KV_TOKEN * 18 == 185_344


def test_decode_counts():
    assert dims().decode_iter_flops([5, 9]) == \
        2 * (BODY + HEAD) * 2 + ATTN * 14 == 368_640
    assert dims().decode_iter_bytes([5, 9]) == \
        (BODY + HEAD) * 2 + KV_TOKEN * 14 == 184_320
    # one layer's call; an idle row (length 0) reads nothing
    flops, nbytes = dims().paged_decode_call([5, 0, 9])
    assert flops == 4 * 4 * 16 * 14 == 3584
    assert nbytes == 2 * 2 * 16 * 2 * 14 + 2 * 4 * 16 * 2 * 2 == 2304
    assert roofline.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert roofline.bound_s(0.0, 3.35e12) == pytest.approx(1.0)


def test_fused_block_rows():
    """A row that stops inside a fused block keeps its length for the
    block's later iterations, and emits no more."""
    step = Step("decode", 0.0, 0.1, 0, 4, False, [(10, 3), (20, 1)], 4)
    assert step.decode_iters() == [([11, 21], [11, 21]), ([12], [12, 21]),
                                   ([13], [13, 21]), ([], [13, 21])]


def test_readers_on_a_hand_made_run():
    steps = [
        Step("prefill_chunk", 0.0, 0.2, 13, 1, False, [(0, 10), (5, 3)], 1,
             n_completed=1),
        Step("decode", 0.2, 0.3, 2, 1, False, [(4, 1), (8, 1)], 2),
        Step("decode", 0.3, 0.5, 4, 2, False, [(5, 2), (9, 2)], 4),
        # profiled: left out of the step metrics
        Step("decode", 0.6, 0.7, 2, 1, True, [(7, 1), (11, 1)], 2),
    ]
    run = Run(cell={}, config=smoke_config(), window_s=1.0, end_s=1.0,
              setup_s=3.0, reqs=[], steps=steps,
              trace={"busy_s": 0.025, "window_s": 0.1,
                     "kernels": {"void paged_group_kernel<16>": {"s": 1e-6,
                                                                "n": 2},
                                 "gemm": {"s": 0.02, "n": 9}}},
              traced_from=0.6)
    read = {m: catalog.reader(m) for m in (
        "engine.prefill_tokens_per_step", "engine.decode_k_mean",
        "step.prefill_ms", "step.decode_iter_ms.tail", "mfu.prefill",
        "mfu.decode", "mfu.window", "paged_decode_attention_roofline.tail",
        "device.idle_share.tail", "output_tok_s", "setup_s")}
    assert read["engine.prefill_tokens_per_step"](run) == 13
    assert read["engine.decode_k_mean"](run) == 1.5
    assert read["step.prefill_ms"](run) == pytest.approx(200.0)
    assert read["step.decode_iter_ms.tail"](run) == pytest.approx(100.0)
    assert read["mfu.prefill"](run) == pytest.approx(
        100 * 1_995_264 / (989e12 * 0.2))
    d = dims()
    least = [roofline.bound_s(d.decode_iter_flops(e),
                              d.decode_iter_bytes(e))
             for e in ([5, 9], [6, 10], [7, 11])]
    assert read["mfu.decode"](run) == pytest.approx(100 * sum(least) / 0.3)
    prefill_least = roofline.bound_s(1_995_264, 185_344)
    assert read["mfu.window"](run) == pytest.approx(
        100 * (sum(least) + prefill_least) / 0.6)
    call = d.paged_decode_call([8, 12])
    assert read["paged_decode_attention_roofline.tail"](run) == \
        pytest.approx(100 * 2 * roofline.bound_s(*call) / 1e-6)
    assert read["device.idle_share.tail"](run) == pytest.approx(75.0)
    assert read["output_tok_s"](run) == 9.0      # 9 tokens in 1 s
    assert read["setup_s"](run) == 3.0
    untraced = Run(cell={}, config=smoke_config(), window_s=1.0, end_s=1.0,
                   setup_s=3.0, reqs=[], steps=steps[:1], trace=None)
    assert read["paged_decode_attention_roofline.tail"](untraced) is None
    assert read["engine.decode_k_mean"](untraced) is None
