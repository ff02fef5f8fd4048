"""The plain reference against the port, and the control that the
correctness limit is set against, at the smoke width on the CPU."""

import numpy as np
import pytest
import torch

from hfxbench import calibrate, catalog, model
from hfxbench.tests.conftest import smoke_cell, smoke_config, smoke_mix

# f32 against f32: the two differ by the order of their sums alone
F32_TOL = 1e-4


def _logits(cfg, seed, precision):
    """(the port's plain forward, the reference's) logits of one prompt,
    from the same weights."""
    ref = catalog.load_module("reference", cfg["reference"])
    weights = model.draw_weights(cfg, seed, "cpu")
    mdl = model.build_model(cfg, weights, "cpu")
    tokens = torch.as_tensor(
        np.random.default_rng(seed).integers(0, cfg["vocab_size"], 48))
    with torch.no_grad():
        port = mdl.forward({"tokens": tokens[None]})[0].float()
    hidden = ref.final_hidden(weights, cfg, [tokens.numpy()], [precision],
                              "cpu")[precision][0]
    return port, ref.logits(weights, hidden, precision)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 7])
def test_reference_equals_the_port_in_f32(seed):
    port, ref = _logits(smoke_config("float32"), seed, "f32")
    assert (port - ref).abs().max().item() < F32_TOL


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 7])
def test_reference_in_bf16_fails_the_f32_tolerance(seed):
    port, ref = _logits(smoke_config("float32"), seed, "bf16")
    assert (port - ref).abs().max().item() > 10 * F32_TOL


def test_fp8_control_reads_far_above_a_bf16_program():
    """The benchmark's own comparison (the widest logit gap of served
    tokens) over served requests: the port in bf16 reads low, the
    reference computed in float8 e4m3 (the control) reads at least
    three times higher on every seed."""
    cell = smoke_cell()
    rows = list(calibrate.readings(cell, smoke_config("bfloat16"),
                                   smoke_mix(), seeds=[100, 101, 102],
                                   seconds=2.0, controls=("fp8",),
                                   device="cpu"))
    program = max(r["program"] for r in rows)
    control = min(r["fp8"] for r in rows)
    assert all(r["mismatches"] == 0 and r["tokens"] >= 100 for r in rows)
    assert control >= 3 * program and control > 0.05
