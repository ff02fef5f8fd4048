#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/kernels/``), then runs eight phases, each printing a JSON line
(``hybrid`` a second one for its hand-off, ``parity`` one per model):

1. ``device``  — the card, its power limit and the kernel build time;
   then ``tensor_cores``: for the flash-attention and SSD libraries,
   ptxas's registers and spills of each tensor-core kernel and the
   HGMMA (wgmma) instructions ``cuobjdump -sass`` finds (none, or no
   cuobjdump, fails the run).
2. ``kernels`` — each kernel against its plain PyTorch version on the
   card (``rtol = atol =`` 2e-5 in f32 with TF32 off, 2e-2 in bf16, the
   gather exactly, SSD 2e-3 in f32 as tests/test_kernels.py holds it)
   at the shapes the main paths give it, plus a ragged and a
   bidirectional flash case, ``kv_len == 0`` decode rows, the three
   attention kernels at zamba2's head dim 112, SSD batches with pad
   rows and RMSNorm at mamba2's norm shapes; each timed (device time
   from ``torch.profiler``'s events; the kernel also with CUDA events
   over back-to-back calls) beside its bound, its plain version and a
   PyTorch library call that computes the same function, where one
   exists (none computes SSD); flash attention and SSD also beside
   their CUDA-core instances on the same bf16 inputs (``fma_ms``).
3. ``serve``   — qwen7b at full width in bf16 (weights drawn on the card
   from a seeded generator) serving 16 Table-1 requests through the
   paged engine; every request must finish with its ``l_out`` tokens
   and the paged decode-attention kernel must have run 32 times per
   C == 1 forward pass.
4. ``pd``      — one request prefilled on engine A, exported, evicted and
   imported into engine B: tokens identical to the colocated run, the
   payload size as predicted, the page-gather kernel launched.
5. ``slot``    — gemma3-4b at full width in bf16 (random weights from a
   seed) serving 16 requests on the slot plane, which the engine picks
   by itself for its sliding-window layers: 12 Table-1 requests and 4
   wikisql prompts longer than the 1024-token window.  Every request
   must finish; flash attention must have run 34 times per prefill
   dispatch and the contiguous decode-attention kernel 5 times (the
   global layers) per C == 1 forward pass.
6. ``mamba``   — mamba2-2.7b at full width in bf16 (random weights from
   a seed) serving the ``serve`` phase's 16 requests on the slot plane
   (``paged=False``): every request must finish, the SSD kernel must
   have run 64 times per prefill dispatch whose padded length is a
   multiple of the 256-token chunk, and no attention kernel at all.
7. ``hybrid``  — zamba2-7b at full width in bf16 serving 8 of those
   requests on its default, paged plane: every request must finish and
   the paged decode kernel (head dim 112) run 13 times, once per shared
   attention invocation, per C == 1 pass; then a P/D hand-off
   (``hybrid_pd``, the ``pd`` checks) to an engine with pages of 32
   whose payload carries 68 layers of SSM/conv slot rows and 13 of
   pages.
8. ``parity``  — f32 with TF32 off, kernel route against plain route on
   the same weights: a 2-layer full-width qwen7b's paged decode logits,
   a 13-layer full-width gemma3 (two local:global groups and a tail)
   prefilling an 1100-token prompt and decoding 8 tokens (logits within
   2e-4), and a 4-layer mamba2 and a 7-layer zamba2 (one 5 + 1 group
   and a tail) prefilling a 1024-token prompt and decoding 8 tokens
   (within 1e-3: the kernel and the plain scan sum the chunked SSD in
   other orders, and the decay ``exp(cum_q - cum_k)`` takes the
   difference of prefix sums that reach the hundreds within a chunk).

Then it prints the card's ``nvidia-smi`` name and power limit, one JSON
line with every kernel's numbers, and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero; it also exits non-zero, printing no result, when
no CUDA card is visible or when it is run outside the repository.

    python3 chip_smoke.py --profile

instead traces, with ``torch.profiler``, one prefill step and two
decode blocks of each full-width engine (qwen7b on the paged plane,
gemma3-4b and mamba2-2.7b on the slot plane), writes the gzipped
chrome traces to ``build/profile/`` and prints the device's busy time,
idle share and kernel time by name for each window.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense

ENGINE = dict(n_slots=8, max_len=2048, prefill_batch=4, page_size=16,
              chunk_size=256, decode_block=8)
N_REQUESTS = 16
MAX_L_IN, MAX_L_OUT = 1536, 256
PD_L_IN, PD_L_OUT = 1000, 24
SLOT_ENGINE = dict(n_slots=8, max_len=2048, prefill_batch=4, decode_block=8)
N_TABLE1_SLOT, N_LONG = 12, 4          # slot phase: Table-1 + long wikisql
LONG_L_IN, LONG_L_OUT = (1100, 1536), 128
PARITY_L_IN, PARITY_DECODE = 1100, 8
MAMBA_ENGINE = dict(SLOT_ENGINE, paged=False)  # mamba2 asks for the slot plane
N_HYBRID = 8                   # hybrid phase: the first 8 Table-1 requests
HYBRID_PD_PAGE_SIZE = 32       # the P/D destination's pages (source: 16)
SSM_PARITY_L_IN, SSM_PARITY_TOL = 1024, 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_row(n_bytes: int, flops: int, flops_per_s: float) -> dict:
    """The least time the card could take, in ms, and what bounds it:
    the bytes over the memory rate or the operations over the peak rate
    of their type, whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / flops_per_s
    return {"bytes": n_bytes, "flops": flops,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------


def attention_inputs(torch, dev, *, dtype, hq, hkv, poison=False,
                     zero_row=False, b=8, d=128, ps=16, mp=128, seed=1):
    """qwen7b's decode shape (zamba2's with d=112): B=8 slots of up to
    2048 tokens in a pool of B*MP pages of 16 tokens; kv_len drawn from
    [1, 2048]."""
    rng = np.random.default_rng(seed)
    n_pages = b * mp
    kv_len = rng.integers(1, mp * ps + 1, size=b).astype(np.int32)
    if zero_row:
        kv_len[0] = 0
    table = rng.permutation(n_pages).astype(np.int32).reshape(b, mp)
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randn(n_pages, hkv, ps, d, generator=g, device=dev)
    v = torch.randn(n_pages, hkv, ps, d, generator=g, device=dev)
    q = torch.randn(b, hq, d, generator=g, device=dev)
    if poison:
        # stale data at every offset past kv_len, unallocated (-1)
        # entries past each sequence's last page
        live = torch.zeros(n_pages, ps, dtype=torch.bool)
        for i in range(b):
            n = int(kv_len[i])
            for t in range(n):
                live[table[i, t // ps], t % ps] = True
            table[i, -(-n // ps):] = -1
        live = live.to(dev)[:, None, :, None]
        k = torch.where(live, k, 1e3)
        v = torch.where(live, v, 1e3)
    return ([x.to(dtype).contiguous() for x in (q, k, v)]
            + [torch.as_tensor(table, device=dev),
               torch.as_tensor(kv_len, device=dev)])


def kernels_phase(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, page_gather, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = {}
    for name, kw, tol in (
        ("mha_bf16", dict(dtype=torch.bfloat16, hq=32, hkv=32), 2e-2),
        ("mha_f32_poisoned", dict(dtype=torch.float32, hq=32, hkv=32,
                                  poison=True), 2e-5),
        ("gqa40_8_bf16", dict(dtype=torch.bfloat16, hq=40, hkv=8), 2e-2),
        ("gqa40_8_f32_kvlen0", dict(dtype=torch.float32, hq=40, hkv=8,
                                    zero_row=True), 2e-5),
        ("zamba2_d112_bf16", dict(dtype=torch.bfloat16, hq=32, hkv=32,
                                  d=112), 2e-2),
        ("zamba2_d112_f32_poisoned", dict(dtype=torch.float32, hq=32,
                                          hkv=32, d=112, poison=True,
                                          zero_row=True), 2e-5),
    ):
        args = attention_inputs(torch, dev, **kw)
        got = decode_attention.paged_decode_attention(*args)
        want = ref.paged_decode_attention_ref(*args)
        cases[name] = compare(torch, got, want, tol,
                              f"paged_decode_attention {name}")
        if kw.get("zero_row"):
            check(bool((got[0] == 0).all()), f"{name}: kv_len 0 row != 0")

    def paged_timing(d):
        """Timing at the main path's decode shape and dtype."""
        q, k, v, table, kv_len = attention_inputs(
            torch, dev, dtype=torch.bfloat16, hq=32, hkv=32, d=d)
        b, hq, _ = q.shape
        hkv, ps = k.shape[1], k.shape[2]
        lens = kv_len.cpu().numpy().astype(np.int64)
        itemsize = q.element_size()
        att_bytes = (int(lens.sum()) * hkv * d * 2 * itemsize
                     + 2 * q.numel() * itemsize + table.numel() * 4 + b * 4)
        att_flops = 4 * int(lens.sum()) * hq * d
        kc = ref.paged_gather(k, table)       # the library call's input
        vc = ref.paged_gather(v, table)
        mask = (torch.arange(kc.shape[2], device=dev)[None, :]
                < kv_len[:, None].long())[:, None, None, :]
        return {
            **timings(
                torch,
                lambda: decode_attention.paged_decode_attention(
                    q, k, v, table, kv_len),
                lambda: ref.paged_decode_attention_ref(q, k, v, table,
                                                       kv_len),
                lambda: F.scaled_dot_product_attention(
                    q[:, :, None, :], kc, vc, attn_mask=mask), 50),
            **bound_row(att_bytes, att_flops, BF16_FLOPS_PER_S),
            "shape": {"B": b, "Hq": hq, "Hkv": hkv, "D": d, "ps": ps,
                      "MP": table.shape[1], "sum_kv_len": int(lens.sum()),
                      "dtype": "bfloat16"},
        }

    att = {**paged_timing(128),
           "max_abs_err": cases["mha_bf16"]["max_abs_err"]}
    cases["zamba2_d112_bf16"].update(paged_timing(112))
    torch.cuda.empty_cache()

    # page gather: exactness with -1 ids, then time at the pd export shape
    g = torch.Generator(device=dev).manual_seed(2)
    n_l, n_pages, h, ps, d = 32, 1024, 32, 16, 128
    pages = torch.randn(n_l, n_pages, h, ps, d, generator=g, device=dev,
                        dtype=torch.bfloat16)
    ids = torch.tensor([5, -1, n_pages - 1, 0, -1, 17], dtype=torch.int32,
                       device=dev)
    exact = torch.equal(page_gather.page_gather(pages, ids),
                        ref.page_gather_ref(pages, ids))
    check(exact, "page_gather differs from its plain version")
    m = -(-PD_L_IN // ps)
    ids = torch.as_tensor(
        np.random.default_rng(3).permutation(n_pages)[:m].astype(np.int32),
        device=dev)
    exact = torch.equal(page_gather.page_gather(pages, ids),
                        ref.page_gather_ref(pages, ids))
    check(exact, "page_gather differs from its plain version (timed shape)")
    gat_bytes = 2 * n_l * m * h * ps * d * pages.element_size() + m * 4

    def library_gather():
        return pages.index_select(1, ids.long()).permute(
            0, 2, 1, 3, 4).contiguous()

    gat = {
        **timings(torch, lambda: page_gather.page_gather(pages, ids),
                  lambda: ref.page_gather_ref(pages, ids), library_gather,
                  50),
        **bound_row(gat_bytes, 0, 1.0),
        "max_abs_err": 0.0,
        "shape": {"L": n_l, "NP": n_pages, "H": h, "ps": ps, "D": d, "M": m,
                  "dtype": "bfloat16"},
    }
    del pages
    torch.cuda.empty_cache()
    flash = flash_kernel_rows(torch, dev)
    dec = decode_kernel_rows(torch, dev)
    ssd = ssd_kernel_rows(torch, dev)
    norm = rmsnorm_kernel_rows(torch, dev)
    emit({"phase": "kernels", "paged_decode_attention": {**att,
          "cases": cases}, "page_gather": gat, "flash_attention": flash,
          "decode_attention": dec, "ssd": ssd, "rmsnorm": norm})
    return {"paged_decode_attention": att, "page_gather": gat,
            "flash_attention": flash, "decode_attention": dec, "ssd": ssd,
            "rmsnorm": norm}


def tensor_core_report(_build) -> dict:
    """For each redesigned library (flash attention, SSD): what ptxas
    said of each tensor-core kernel (registers, spills, stack and any
    C75xx performance note, from the -Xptxas -v build) and the HGMMA
    (wgmma) instructions per function in ``cuobjdump -sass``.  Fails if
    cuobjdump is missing from the toolkit or a library holds no HGMMA."""
    cuobjdump = _build.cuda_tool("cuobjdump")
    out = {}
    for name in ("flash_attention", "ssd"):
        sass = subprocess.run(
            [cuobjdump, "-sass", str(_build.library_path(name))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        hgmma: dict[str, int] = {}
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
            elif fn and re.search(r"\bHGMMA\b", line):
                hgmma[fn] = hgmma.get(fn, 0) + 1
        check(sum(hgmma.values()) > 0,
              f"the {name} library holds no HGMMA instruction")
        ptxas: dict[str, dict] = {}
        notes = []
        cur = None
        for line in _build.build_log.get(name, "").splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = m.group(1) if re.search(r"_(tc|cb)_kernel", m.group(1)) \
                    else None
                if cur:
                    ptxas[cur] = {}
            elif "C75" in line:
                notes.append(line.strip())
            elif cur:
                for key, pat in (("registers", r"Used (\d+) registers"),
                                 ("stack_bytes", r"(\d+) bytes stack frame"),
                                 ("spill_stores", r"(\d+) bytes spill stores"),
                                 ("spill_loads", r"(\d+) bytes spill loads")):
                    m = re.search(pat, line)
                    if m:
                        ptxas[cur][key] = int(m.group(1))
        out[name] = {"hgmma": sum(hgmma.values()), "hgmma_by_function": hgmma,
                     "ptxas": ptxas or "built earlier: no ptxas report",
                     "ptxas_notes": notes}
    return out


def compare(torch, got, want, tol, name):
    """``got`` against ``want`` with ``rtol = atol = tol``, the criterion
    of tests/test_kernels.py (fails on a non-finite value too); returns
    the max abs error with the scale of what was compared."""
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    worst = float((diff / (tol + tol * want.float().abs())).max())
    check(worst <= 1.0, f"{name}: max abs err {err} exceeds rtol = atol "
                        f"= {tol} (by x{worst:.3g})")
    return {"max_abs_err": err, "tol": tol,
            "want_absmax": float(want.float().abs().max()),
            "want_std": float(want.float().std())}


def timings(torch, kernel, plain, library, iters: int,
            plain_iters: int = 5) -> dict:
    """Device times of a kernel, its plain version and the library call
    that computes the same function (None where there is none), and the
    kernel's CUDA-event time over back-to-back calls (``event_ms``),
    which also holds the host's launch gaps."""
    return {"ms": device_ms(torch, kernel),
            "plain_ms": device_ms(torch, plain, plain_iters),
            "library_ms": None if library is None
            else device_ms(torch, library),
            "event_ms": cuda_ms(torch, kernel, iters)}


def device_ms(torch, fn, iters: int = 5) -> float:
    """Device time of one call of ``fn``: the durations of what it runs
    on the card, from ``torch.profiler``'s events over ``iters`` calls,
    summed and divided by ``iters``.  Unlike ``cuda_ms`` it leaves out
    the host's gaps between launches, which dominate calls of a few
    tens of microseconds.  The tracer now and then hands back no device
    event for a whole window (seen for library calls that record fine in
    other runs), so a window without one is traced again, up to three
    times, before the run fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / iters
    check(False, "the profiler recorded no device time in three windows")


def flash_pairs(s: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one (b, head) of flash attention."""
    q = np.arange(s)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(s, int)
    hi = q + 1 if causal else np.full(s, s)
    return int((hi - lo).sum())


def flash_kernel_rows(torch, dev):
    """Flash attention against its plain version at gemma3's prefill
    shape (global and local layers) and qwen7b's, ragged S, narrow
    windows and bidirectional cases in both dtypes (bf16 on the tensor-
    core instance, f32 on the CUDA-core one); timed at gemma3's
    local-layer shape, which 29 of its 34 layers run, beside the
    CUDA-core instance on the same bf16 inputs (``fma_ms``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref

    bf16, f32 = torch.bfloat16, torch.float32
    cases = {}
    for name, (b, hq, hkv, s, d), causal, window, dt, tol in (
        ("gemma3_global_bf16", (4, 8, 4, 2048, 256), True, 0, bf16, 2e-2),
        ("gemma3_local_bf16", (4, 8, 4, 2048, 256), True, 1024, bf16, 2e-2),
        ("gemma3_local_f32", (4, 8, 4, 2048, 256), True, 1024, f32, 2e-5),
        ("qwen7b_bf16", (4, 32, 32, 2048, 128), True, 0, bf16, 2e-2),
        ("ragged40_f32", (2, 8, 4, 40, 256), True, 0, f32, 2e-5),
        ("bidirectional_f32", (2, 8, 4, 300, 256), False, 0, f32, 2e-5),
        ("zamba2_d112_bf16", (4, 32, 32, 2048, 112), True, 0, bf16, 2e-2),
        ("zamba2_d112_ragged_f32", (1, 32, 32, 1100, 112), True, 0, f32,
         2e-5),
        ("ragged1100_window64_bf16", (2, 8, 4, 1100, 256), True, 64, bf16,
         2e-2),
        ("ragged40_bf16", (2, 8, 4, 40, 256), True, 0, bf16, 2e-2),
        ("bidirectional_d112_bf16", (1, 32, 32, 1100, 112), False, 0, bf16,
         2e-2),
        ("qwen7b_window64_bf16", (2, 32, 32, 300, 128), True, 64, bf16,
         2e-2),
    ):
        g = torch.Generator(device=dev).manual_seed(s + d + window)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt)
                   for shape in ((b, hq, s, d), (b, hkv, s, d),
                                 (b, hkv, s, d)))
        got = flash_attention.flash_attention(q, k, v, causal=causal,
                                              window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        cases[name] = compare(torch, got, want, tol, f"flash {name}")
        del got, want
        if name not in ("gemma3_global_bf16", "gemma3_local_bf16",
                        "zamba2_d112_bf16"):
            continue
        pos = torch.arange(s, device=dev)
        band = pos[None, :] <= pos[:, None]
        if window:
            band &= (pos[:, None] - pos[None, :]) < window
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 4 * b * hq * d * flash_pairs(s, causal, window)
        cases[name].update(
            **timings(
                torch,
                lambda: flash_attention.flash_attention(
                    q, k, v, causal=causal, window=window),
                lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                                window=window),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=band, enable_gqa=True), 10),
            # the CUDA-core instance on the same inputs
            fma_ms=device_ms(torch, lambda: flash_attention.flash_attention(
                q, k, v, causal=causal, window=window, fma=True)),
            **bound_row(n_bytes, flops, BF16_FLOPS_PER_S),
            shape={"B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d,
                   "causal": causal, "window": window, "dtype": "bfloat16"})
        del q, k, v, band
    torch.cuda.empty_cache()
    return {**cases["gemma3_local_bf16"], "cases": cases}


def decode_kernel_rows(torch, dev):
    """Contiguous decode attention against its plain version at gemma3's
    decode shape (8 slots of up to 2048 tokens, GQA 8/4, D 256, one
    ``kv_len == 0`` row) and qwen7b's MHA shape; timed at gemma3's."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, ref

    bf16, f32 = torch.bfloat16, torch.float32
    cases = {}
    for name, (b, hq, hkv, s, d), dt, tol in (
        ("gemma3_bf16_kvlen0", (8, 8, 4, 2048, 256), bf16, 2e-2),
        ("gemma3_f32_kvlen0", (8, 8, 4, 2048, 256), f32, 2e-5),
        ("qwen7b_mha_bf16", (8, 32, 32, 2048, 128), bf16, 2e-2),
        ("zamba2_d112_bf16_kvlen0", (8, 32, 32, 2048, 112), bf16, 2e-2),
        ("zamba2_d112_f32_kvlen0", (8, 32, 32, 2048, 112), f32, 2e-5),
    ):
        g = torch.Generator(device=dev).manual_seed(s + d + hq)
        q = torch.randn(b, hq, d, generator=g, device=dev).to(dt)
        k, v = (torch.randn(b, hkv, s, d, generator=g, device=dev).to(dt)
                for _ in range(2))
        lens = np.random.default_rng(hq + d).integers(1, s + 1, size=b)
        if "kvlen0" in name:
            lens[0] = 0
        kv_len = torch.as_tensor(lens.astype(np.int32), device=dev)
        got = decode_attention.decode_attention(q, k, v, kv_len)
        want = ref.decode_attention_ref(q, k, v, kv_len)
        cases[name] = compare(torch, got, want, tol, f"decode {name}")
        if "kvlen0" in name:
            check(bool((got[0] == 0).all()), f"{name}: kv_len 0 row != 0")
        if name not in ("gemma3_bf16_kvlen0", "zamba2_d112_bf16_kvlen0"):
            continue
        mask = (torch.arange(s, device=dev)[None, :]
                < kv_len[:, None].long())[:, None, None, :]
        n_bytes = (int(lens.sum()) * hkv * d * 2 * q.element_size()
                   + 2 * q.numel() * q.element_size() + 4 * b)
        flops = 4 * int(lens.sum()) * hq * d
        cases[name].update(
            **timings(
                torch,
                lambda: decode_attention.decode_attention(q, k, v, kv_len),
                lambda: ref.decode_attention_ref(q, k, v, kv_len),
                lambda: F.scaled_dot_product_attention(
                    q[:, :, None, :], k, v, attn_mask=mask, enable_gqa=True),
                50),
            **bound_row(n_bytes, flops, BF16_FLOPS_PER_S),
            shape={"B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d,
                   "sum_kv_len": int(lens.sum()), "dtype": "bfloat16"})
    torch.cuda.empty_cache()
    return {**cases["gemma3_bf16_kvlen0"], "cases": cases}


def ssd_inputs(torch, dev, *, b, s, h, p, n, dtype, lens=None, seed=3):
    """SSD operands drawn as tests/test_kernels.py draws them: x, B, C
    normal; dt softplus of a normal (f32), 0 past ``lens``; a = -exp of
    half a normal (f32)."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=g, device=dev).to(dtype)
    dt = F.softplus(torch.randn(b, s, h, generator=g, device=dev))
    if lens is not None:
        pos = torch.arange(s, device=dev)[None, :]
        dt = dt * (pos < torch.tensor(lens, device=dev)[:, None])[..., None]
    a = -torch.exp(0.5 * torch.randn(h, generator=g, device=dev))
    bm = torch.randn(b, s, n, generator=g, device=dev).to(dtype)
    cm = torch.randn(b, s, n, generator=g, device=dev).to(dtype)
    return x, dt.contiguous(), a, bm, cm


def ssd_work(b, s, h, p, n, q, itemsize) -> tuple[int, int]:
    """Bytes the SSD must move (x and B/C and dt read, y and the final
    state written, once each) and the least flops it must do: the
    causal half of C B^T once per (b, chunk), for all heads (it does
    not depend on the head), and per (b, head, chunk) the causal half
    of S x, reachable pairs as the flash row counts them, plus C . state
    and the state update."""
    n_bytes = (2 * b * s * h * p * itemsize + 2 * b * s * n * itemsize
               + 4 * b * s * h + 4 * h + 4 * b * h * p * n)
    per_chunk = q * (q + 1) * n
    per_head_chunk = q * (q + 1) * p + 4 * q * p * n
    return n_bytes, b * (s // q) * (per_chunk + h * per_head_chunk)


def ssd_kernel_rows(torch, dev):
    """The SSD kernel against the sequential recurrence at mamba2's and
    zamba2's prefill shapes (B 4, S 2048, P 64, Q 256; H 80 / N 128 and
    H 112 / N 64), with pad rows (dt = 0 past each row's length), f32
    (2e-3, the CUDA-core instance) and bf16 (2e-2, the tensor-core
    one); timed in bf16 at both, beside the model's plain chunked scan
    (the route taken when the kernel's gate fails) and the CUDA-core
    instance on the same inputs (``fma_ms``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd as ssd_mod
    from repro_torch.models import mamba2

    bf16, f32 = torch.bfloat16, torch.float32
    lens = [2048, 1500, 700, 37]
    cases = {}
    for name, h, n, dt_, tol in (
        ("mamba2_bf16_padded", 80, 128, bf16, 2e-2),
        ("mamba2_f32_padded", 80, 128, f32, 2e-3),
        ("zamba2_bf16_padded", 112, 64, bf16, 2e-2),
        ("zamba2_f32_padded", 112, 64, f32, 2e-3),
    ):
        b, s, p, q = 4, 2048, 64, 256
        x, dt, a, bm, cm = ssd_inputs(torch, dev, b=b, s=s, h=h, p=p, n=n,
                                      dtype=dt_, lens=lens)
        y, st = ssd_mod.ssd(x, dt, a, bm, cm, chunk=q)
        y_ref, st_ref = ref.ssd_ref(x, dt, a, bm, cm)
        cases[name] = compare(torch, y, y_ref, tol, f"ssd {name} y")
        cases[name]["state"] = compare(torch, st, st_ref, tol,
                                       f"ssd {name} state")
        del y, st, y_ref, st_ref
        if dt_ is f32:
            continue
        n_bytes, flops = ssd_work(b, s, h, p, n, q, x.element_size())
        cases[name].update(
            **timings(torch,
                      lambda: ssd_mod.ssd(x, dt, a, bm, cm, chunk=q),
                      lambda: ref.ssd_ref(x, dt, a, bm, cm), None, 10,
                      plain_iters=1),
            scan_ms=device_ms(torch, lambda: mamba2.ssd_scan(
                x, dt, a, bm[:, :, None], cm[:, :, None], chunk=q), 2),
            # the CUDA-core instance on the same inputs
            fma_ms=device_ms(torch, lambda: ssd_mod.ssd(
                x, dt, a, bm, cm, chunk=q, fma=True)),
            tensor_cores=ssd_mod.uses_tensor_cores(x, n),
            **bound_row(n_bytes, flops, BF16_FLOPS_PER_S),
            shape={"B": b, "S": s, "H": h, "P": p, "N": n, "Q": q,
                   "lens": lens, "dtype": "bfloat16"})
        del x, dt, a, bm, cm
        torch.cuda.empty_cache()
    return {**cases["mamba2_bf16_padded"], "cases": cases}


def rmsnorm_kernel_rows(torch, dev):
    """RMSNorm against its plain version at mamba2's gated norm (8192
    rows of d_inner 5120, a 4 x 2048 prefill) and block norm (d 2560),
    bf16 (2e-2) and f32 (2e-5), and an odd row count at zamba2's widest
    norm (d_inner 7168); timed in bf16 at both mamba2 shapes beside
    ``F.rms_norm`` with the ``(1 + scale)`` weight precomputed."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rmsnorm_mod

    bf16, f32 = torch.bfloat16, torch.float32
    cases = {}
    for name, rows, d, dt_, tol in (
        ("mamba2_gated_bf16", 8192, 5120, bf16, 2e-2),
        ("mamba2_block_bf16", 8192, 2560, bf16, 2e-2),
        ("mamba2_gated_f32", 8192, 5120, f32, 2e-5),
        ("zamba2_gated_odd_rows_f32", 1001, 7168, f32, 2e-5),
    ):
        g = torch.Generator(device=dev).manual_seed(rows + d)
        x = torch.randn(rows, d, generator=g, device=dev).to(dt_)
        scale = 0.1 * torch.randn(d, generator=g, device=dev)
        got = rmsnorm_mod.rmsnorm(x, scale)
        cases[name] = compare(torch, got, ref.rmsnorm_ref(x, scale), tol,
                              f"rmsnorm {name}")
        if dt_ is f32:
            continue
        weight = (1.0 + scale).to(dt_)
        cases[name].update(
            **timings(torch, lambda: rmsnorm_mod.rmsnorm(x, scale),
                      lambda: ref.rmsnorm_ref(x, scale),
                      lambda: F.rms_norm(x, (d,), weight, 1e-5), 50),
            **bound_row(2 * x.numel() * x.element_size() + 4 * d,
                        4 * x.numel(), F32_FLOPS_PER_S),
            shape={"rows": rows, "D": d, "dtype": "bfloat16",
                   "scale": "float32"})
    torch.cuda.empty_cache()
    return {**cases["mamba2_gated_bf16"], "cases": cases}


# ---------------------------------------------------------------------------
# phase 3: serve
# ---------------------------------------------------------------------------


def table1_requests(vocab: int):
    from repro_torch.core.request import FOUR_TASK_SET, TASKS, Request

    rng = np.random.default_rng(SEED)
    reqs = []
    for i in range(N_REQUESTS):
        spec = TASKS[FOUR_TASK_SET[i % len(FOUR_TASK_SET)]]
        l_in, l_out = spec.sample_lengths(rng)
        l_in, l_out = min(l_in, MAX_L_IN), min(l_out, MAX_L_OUT)
        prompt = rng.integers(0, vocab, size=l_in).astype(np.int32)
        reqs.append(Request.from_prompt(
            i, prompt, l_out, task=spec.name, ttft_slo=spec.ttft_slo,
            tpot_slo=spec.tpot_slo))
    return reqs


def c1_passes(engine) -> int:
    """C == 1 forward passes the engine ran: one per decode iteration,
    whether per-token or inside a fused K-block."""
    return sum(k * n for k, n in engine.decode_block_hist.items())


def serve_phase(torch, dev, model, init_s: float):
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    cfg = model.cfg
    engine = InferenceEngine(model, EngineConfig(**ENGINE))
    reqs = table1_requests(cfg.vocab_size)
    out = drive(torch, engine, reqs, "serve")
    launches, passes = out["launches"], out["c1_passes"]
    check(launches["paged_decode_attention"] == cfg.n_layers * passes,
          f"decode-attention launches {launches['paged_decode_attention']}"
          f" != {cfg.n_layers} x {passes} C==1 passes")
    check(launches["page_gather"] == 0, "serve phase exported KV")
    out.update(engine=ENGINE, init_s=init_s)
    emit(out)
    del engine
    torch.cuda.empty_cache()
    return out


def drive(torch, engine, reqs, phase: str) -> dict:
    """Serve ``reqs`` (all arriving at t=0) to completion with the
    launch counts set to 0 just before; check that every request got
    its ``l_out`` tokens; return the phase's summary."""
    from repro_torch.kernels import ops
    from repro_torch.serving.metrics import compute_metrics

    cfg = engine.model.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    steps = 0
    time_by_kind: dict[str, float] = {}
    steps_by_kind: dict[str, int] = {}
    while engine.queue or engine.prefilling or engine.active:
        ev = engine.step()
        steps += 1
        kind = ev["kind"]
        time_by_kind[kind] = time_by_kind.get(kind, 0.0) + ev.get("time", 0.0)
        steps_by_kind[kind] = steps_by_kind.get(kind, 0) + 1
        if steps % 25 == 0:
            engine.fit_profiler()   # refresh Eq. 1/2 online
        check(steps < 20_000, f"{phase} phase did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()

    for r in reqs:
        check(r.finish_time is not None and len(r.generated) == r.l_out,
              f"request {r.rid} produced {len(r.generated)} of {r.l_out}")
    m = compute_metrics(reqs, cost_units=engine.clock,
                        makespan=engine.clock)
    ttft = np.array([r.ttft for r in reqs])
    tpot = np.array([r.tpot for r in reqs])
    decode_s = time_by_kind.get("decode", 0.0)
    return {
        "phase": phase, "model": cfg.name, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model,
        "dtype": str(engine.model.dtype).removeprefix("torch."),
        "params": cfg.param_count(), "paged": engine.paged,
        "served": m.n_finished, "n_total": m.n_total,
        "prompt_tokens": int(sum(r.l_in for r in reqs)),
        "output_tokens": int(sum(r.l_out for r in reqs)),
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_p99_s": float(np.percentile(ttft, 99)),
        "tpot_p50_s": float(np.percentile(tpot, 50)),
        "tpot_p99_s": float(np.percentile(tpot, 99)),
        "decode_tok_per_s": engine.n_decode_tokens / max(decode_s, 1e-9),
        "metrics": m.row(),
        "steps": steps, "steps_by_kind": steps_by_kind,
        "time_by_kind_s": time_by_kind, "wall_s": wall,
        "engine_clock_s": engine.clock,
        "decode_block_hist": engine.decode_block_hist,
        "c1_passes": c1_passes(engine), "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


# ---------------------------------------------------------------------------
# phase 4: P/D hand-off
# ---------------------------------------------------------------------------


def pd_phase(torch, dev, model, phase: str = "pd", dst_engine=ENGINE):
    """One request prefilled on engine A (``ENGINE``), exported, evicted
    and imported into engine B (``dst_engine``, whose page size may
    differ): tokens identical to a colocated run, ``kv_bytes_of`` equal
    to the payload's bytes, the page-gather kernel launched, the paged
    decode kernel once per attention layer and C == 1 pass on B; the
    payload holds every attention layer's pages and every Mamba-2
    layer's slot rows."""
    from repro_torch.core.request import Request
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    prompt = np.random.default_rng(SEED + 1).integers(
        0, model.cfg.vocab_size, size=PD_L_IN).astype(np.int32)

    def req():
        return Request.from_prompt(0, prompt, PD_L_OUT)

    base = InferenceEngine(model, EngineConfig(**ENGINE))
    r0 = req()
    base.submit(r0)
    base.run_until_done()
    want = list(r0.generated)
    check(len(want) == PD_L_OUT, "colocated baseline fell short")
    del base
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    a = InferenceEngine(model, EngineConfig(**ENGINE))
    a.park_on_prefill = True
    r = req()
    a.submit(r)
    a.run_until_done()
    check(r.slot in a.parked, "request did not park after prefill")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payload = a.export_kv(r.rid)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    predicted = a.kv_bytes_of(r.rid)
    check(predicted == payload.nbytes,
          f"kv_bytes_of {predicted} != payload {payload.nbytes}")
    layers = {}
    for seg in payload.kv:
        for name, t in seg.items():
            layers[name] = t.shape[0]
    check(layers.get("k_pages", 0) == model.n_attn
          and layers.get("ssm", 0) == model.n_mamba,
          f"payload layers {layers} != {model.n_attn} paged + "
          f"{model.n_mamba} slot-row layers")
    a.evict(r.slot)
    del a
    torch.cuda.empty_cache()
    b = InferenceEngine(model, EngineConfig(**dst_engine))
    check(b.import_kv(payload, r), "import_kv refused the payload")
    b.run_until_done()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check(r.generated == want, "P/D tokens differ from the colocated run")
    check(launches["page_gather"] > 0, "export did not launch page_gather")
    check(launches["paged_decode_attention"]
          == model.n_attn * c1_passes(b),
          "decode-attention launches do not match engine B's passes")
    out = {"phase": phase, "model": model.cfg.name, "l_in": PD_L_IN,
           "l_out": PD_L_OUT, "page_size": [ENGINE["page_size"],
                                            dst_engine["page_size"]],
           "tokens_identical": True, "payload_bytes": payload.nbytes,
           "payload_layers": layers, "export_s": export_s,
           "launches": launches}
    emit(out)
    del b, payload
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 5: slot plane, gemma3-4b
# ---------------------------------------------------------------------------


def slot_requests(vocab: int):
    """12 Table-1 requests (the serve phase's draw) and, after every
    third, one wikisql request whose prompt exceeds the 1024-token
    window — Table-1 prompts average well under it."""
    from repro_torch.core.request import TASKS, Request

    base = table1_requests(vocab)[:N_TABLE1_SLOT]
    spec = TASKS["wikisql"]
    rng = np.random.default_rng(SEED + 5)
    long = []
    for _ in range(N_LONG):
        l_in = int(rng.integers(LONG_L_IN[0], LONG_L_IN[1] + 1))
        l_out = min(spec.sample_lengths(rng)[1], LONG_L_OUT)
        long.append((rng.integers(0, vocab, size=l_in).astype(np.int32),
                     l_out))
    order = []
    for j in range(N_LONG):
        order += base[3 * j: 3 * j + 3] + [long[j]]
    reqs = []
    for i, r in enumerate(order):
        if isinstance(r, tuple):
            reqs.append(Request.from_prompt(
                i, r[0], r[1], task=spec.name, ttft_slo=spec.ttft_slo,
                tpot_slo=spec.tpot_slo))
        else:
            r.rid = i
            reqs.append(r)
    return reqs


def slot_phase(torch, dev, model, init_s: float):
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    cfg = model.cfg
    engine = InferenceEngine(model, EngineConfig(**SLOT_ENGINE))
    check(not engine.paged, "the engine did not pick the slot plane")
    reqs = slot_requests(cfg.vocab_size)
    n_over = sum(r.l_in > cfg.window for r in reqs)
    check(n_over >= N_LONG, f"only {n_over} prompts exceed the window")
    out = drive(torch, engine, reqs, "slot")
    launches, passes = out["launches"], out["c1_passes"]
    n_prefill = out["steps_by_kind"].get("prefill", 0)
    n_global = sum(w == 0 for w in model.windows)
    check(launches["flash_attention"] == cfg.n_layers * n_prefill,
          f"flash launches {launches['flash_attention']} != "
          f"{cfg.n_layers} x {n_prefill} prefill dispatches")
    check(launches["decode_attention"] == n_global * passes,
          f"decode-attention launches {launches['decode_attention']} != "
          f"{n_global} x {passes} C==1 passes")
    check(launches["paged_decode_attention"] == launches["page_gather"] == 0,
          "the slot phase ran a paged-plane kernel")
    out.update(engine=SLOT_ENGINE, init_s=init_s, window=cfg.window,
               prompts_over_window=n_over, global_layers=n_global,
               prefill_dispatches=n_prefill)
    emit(out)
    del engine
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 6-7: mamba2 on the slot plane, zamba2 on the paged plane
# ---------------------------------------------------------------------------


def mamba_phase(torch, dev, model, init_s: float):
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    cfg = model.cfg
    engine = InferenceEngine(model, EngineConfig(**MAMBA_ENGINE))
    check(not engine.paged, "the engine did not take the slot plane")
    shapes = []          # (B, padded S) of each prefill dispatch
    prefill = model.prefill

    def recording_prefill(tokens, lens, **kw):
        shapes.append(tuple(tokens.shape))
        return prefill(tokens, lens, **kw)

    model.prefill = recording_prefill
    try:
        out = drive(torch, engine, table1_requests(cfg.vocab_size), "mamba")
    finally:
        del model.prefill
    launches = out["launches"]
    n_ssd = sum(s % cfg.ssm.chunk_size == 0 for _, s in shapes)
    check(n_ssd > 0, f"no prefill dispatch reached the SSD gate: {shapes}")
    check(launches["ssd"] == cfg.n_layers * n_ssd,
          f"ssd launches {launches['ssd']} != {cfg.n_layers} x {n_ssd} "
          f"prefill dispatches padded to a multiple of "
          f"{cfg.ssm.chunk_size}")
    others = {k: n for k, n in launches.items() if k != "ssd" and n}
    check(not others, f"the mamba phase ran other kernels: {others}")
    out.update(engine=MAMBA_ENGINE, init_s=init_s, prefill_shapes=shapes,
               ssd_dispatches=n_ssd)
    emit(out)
    del engine
    torch.cuda.empty_cache()
    return out


def hybrid_phase(torch, dev, model, init_s: float):
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    engine = InferenceEngine(model, EngineConfig(**ENGINE))
    check(engine.paged, "the engine did not take the paged plane")
    reqs = table1_requests(model.cfg.vocab_size)[:N_HYBRID]
    out = drive(torch, engine, reqs, "hybrid")
    launches, passes = out["launches"], out["c1_passes"]
    check(launches["paged_decode_attention"] == model.n_attn * passes,
          f"decode-attention launches {launches['paged_decode_attention']}"
          f" != {model.n_attn} shared-attention layers x {passes} C==1 "
          f"passes")
    # chunked prefill carries the SSM state, so the SSD takes the plain
    # scan there, as in the JAX package
    others = {k: n for k, n in launches.items()
              if k != "paged_decode_attention" and n}
    check(not others, f"the hybrid phase ran other kernels: {others}")
    out.update(engine=ENGINE, init_s=init_s, attn_layers=model.n_attn,
               mamba_layers=model.n_mamba)
    emit(out)
    del engine
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 8: kernel path vs plain path, f32
# ---------------------------------------------------------------------------


def parity_phase(torch, dev, cfg):
    from repro_torch.models.build import Model
    from repro_torch.serving.kv_manager import PagedKVManager

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = dataclasses.replace(cfg, n_layers=2)
    model = Model(small, dtype=torch.float32, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(SEED + 2))
    n_slots, max_len, ps, chunk = 4, 2048, 16, 256
    kv = PagedKVManager(n_slots, max_len, ps, device=dev)
    caches = model.init_paged_cache(n_slots, max_len, ps, kv.n_pages)
    rng = np.random.default_rng(SEED + 3)
    lens = [700, 33, 1290, 5]
    prompts = [rng.integers(0, small.vocab_size, n).astype(np.int32)
               for n in lens]
    pos = np.zeros(n_slots, np.int32)
    while any(pos[i] < n for i, n in enumerate(lens)):
        tokens = np.zeros((n_slots, chunk), np.int32)
        take = np.zeros(n_slots, np.int32)
        for i, p in enumerate(prompts):
            t = min(chunk, len(p) - int(pos[i]))
            tokens[i, :t] = p[pos[i]:pos[i] + t]
            take[i] = t
            check(kv.ensure(i, int(pos[i] + t)), "parity pool too small")
        logits, caches = model.chunk_step(
            caches, kv.device_table(), torch.as_tensor(tokens, device=dev),
            torch.as_tensor(pos, device=dev), torch.as_tensor(take,
                                                              device=dev))
        pos += take
    last = logits.argmax(-1).to(torch.int32)
    plain = [{k: t.clone() for k, t in seg.items()} for seg in caches]
    ones = torch.ones(n_slots, dtype=torch.int32, device=dev)
    errs = []
    for _ in range(4):
        for i in range(n_slots):
            check(kv.ensure(i, int(pos[i]) + 1), "parity pool too small")
        args = (kv.device_table(), last[:, None],
                torch.as_tensor(pos, device=dev), ones)
        model.use_kernels = True
        lk, caches = model.chunk_step(caches, *args)
        model.use_kernels = False
        lp, plain = model.chunk_step(plain, *args)
        torch.cuda.synchronize()
        errs.append(float((lk - lp).abs().max()))
        last = lk.argmax(-1).to(torch.int32)
        pos += 1
    err = max(errs)
    check(err <= 2e-4, f"kernel vs plain decode logits differ by {err}")
    out = {"phase": "parity", "model": small.name, "n_layers": 2,
           "d_model": small.d_model, "dtype": "float32", "prompt_lens": lens,
           "max_abs_logit_err": err, "tol": 2e-4,
           "logit_absmax": float(lk.abs().max())}
    emit(out)
    del model, caches, plain
    torch.cuda.empty_cache()
    return out


def slot_parity_phase(torch, dev, cfg, n_layers: int, l_in: int,
                      tol: float, seed: int):
    """A full-width model in f32, cut to ``n_layers`` (gemma3: two
    local:global groups and a 1-layer local tail, the JAX package's
    group layout; mamba2: 4 Mamba-2 layers; zamba2: 5 Mamba-2 layers, the
    shared attention block and a Mamba-2 tail): prefill of one
    ``l_in``-token prompt, then decode steps, once through the kernels
    and once through the plain routes, on the same weights."""
    from repro_torch.kernels import ops
    from repro_torch.models.build import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = dataclasses.replace(cfg, n_layers=n_layers)
    model = Model(small, dtype=torch.float32, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    # decode attention runs on the attention layers without a window
    n_global = sum(k != "mamba" and w == 0
                   for k, w in zip(model.kinds, model.windows))
    n_ssd = (model.n_mamba if small.ssm is not None
             and l_in % small.ssm.chunk_size == 0 else 0)
    prompt = np.random.default_rng(seed + 1).integers(
        0, small.vocab_size, size=l_in).astype(np.int32)
    tokens = torch.as_tensor(prompt[None], device=dev)
    lens = torch.tensor([l_in], dtype=torch.int32, device=dev)
    runs = {}
    ops.reset_launch_counts()
    for use_kernels in (True, False):
        model.use_kernels = use_kernels
        runs[use_kernels] = model.prefill(tokens, lens,
                                          cache_len=SLOT_ENGINE["max_len"])
    torch.cuda.synchronize()
    errs = [float((runs[True][0] - runs[False][0]).abs().max())]
    last = runs[True][0].argmax(-1).to(torch.int32)
    for i in range(PARITY_DECODE):
        pos = torch.tensor([l_in + i], dtype=torch.int32, device=dev)
        for use_kernels in (True, False):
            model.use_kernels = use_kernels
            runs[use_kernels] = model.decode_step(runs[use_kernels][1], last,
                                                  pos)
        torch.cuda.synchronize()
        errs.append(float((runs[True][0] - runs[False][0]).abs().max()))
        last = runs[True][0].argmax(-1).to(torch.int32)
    launches = ops.launch_counts()
    check(launches["flash_attention"] == model.n_attn,
          f"parity prefill launched flash {launches['flash_attention']}x")
    check(launches["decode_attention"] == n_global * PARITY_DECODE,
          f"parity decode launched {launches['decode_attention']}x")
    check(launches["ssd"] == n_ssd,
          f"parity prefill launched ssd {launches['ssd']}x, not {n_ssd}")
    err = max(errs)
    check(err <= tol, f"{small.name} kernel vs plain logits differ by {err}")
    out = {"phase": "parity", "model": small.name, "n_layers": n_layers,
           "kinds": sorted(set(model.kinds)), "d_model": small.d_model,
           "dtype": "float32", "prompt_len": l_in, "window": small.window,
           "decode_steps": PARITY_DECODE, "prefill_abs_logit_err": errs[0],
           "max_abs_logit_err": err, "tol": tol, "launches": launches,
           "logit_absmax": float(runs[True][0].abs().max())}
    emit(out)
    del model, runs
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# --profile: where the time of a prefill chunk and of decode blocks goes
# ---------------------------------------------------------------------------


def trace_summary(path: Path, wall_s: float) -> dict:
    """Device busy time (union of kernel intervals), kernel time by name
    and launch count from a chrome trace of ``torch.profiler``."""
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict[str, list] = {}
    for e in kernels:
        row = by_name.setdefault(e["name"][:80], [0.0, 0])
        row[0] += e["dur"] / 1e3
        row[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_ms": 1e3 * wall_s, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / 1e3 / (1e3 * wall_s),
            "n_kernels": len(kernels),
            "n_cpu_ops": sum(e.get("cat") == "cpu_op" for e in events),
            "top_kernels_ms": {k: {"ms": v[0], "n": v[1]} for k, v in top}}


def profile_phase(torch, dev, model, engine_kw: dict, l_in: int,
                  out_dir: Path):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.request import Request
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    out_dir.mkdir(parents=True, exist_ok=True)
    engine = InferenceEngine(model, EngineConfig(**engine_kw))
    rng = np.random.default_rng(SEED + 4)
    for i in range(engine_kw["n_slots"]):
        prompt = rng.integers(0, model.cfg.vocab_size, l_in).astype(np.int32)
        engine.submit(Request.from_prompt(i, prompt, 64))
    result = {"phase": "profile", "model": model.cfg.name,
              "paged": engine.paged,
              "requests": f"{engine_kw['n_slots']} x ({l_in} in, 64 out)"}

    def window(name: str, n_steps: int) -> None:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            evs = [engine.step() for _ in range(n_steps)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        path = out_dir / f"trace_{model.cfg.name}_{name}.json.gz"
        prof.export_chrome_trace(str(path))
        result[name] = {**trace_summary(path, wall),
                        "steps": [(e["kind"], e.get("k"), e.get("tokens"))
                                  for e in evs]}

    engine.step()                 # first prefill: cuBLAS picks its kernels
    window("prefill", 1)
    while engine.queue or engine.prefilling:
        engine.step()
    engine.step()                 # first full-batch decode block
    window("decode", 2)
    emit(result)
    del engine
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} holds no src/repro_torch; run it from "
              f"the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.build import Model

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    build_s = _build.build_all()
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", file=sys.stderr)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "build_s": build_s,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    emit({"phase": "tensor_cores", **tensor_core_report(_build)})

    def load(name: str, dtype=torch.bfloat16):
        t0 = time.perf_counter()
        model = Model(get_config(name), dtype=dtype, device=dev)
        model.init(torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        return model, time.perf_counter() - t0

    if "--profile" in sys.argv[1:]:
        for name, engine_kw, l_in in (("qwen7b", ENGINE, 512),
                                      ("gemma3-4b", SLOT_ENGINE, 1100),
                                      ("mamba2-2.7b", MAMBA_ENGINE, 1100)):
            model, _ = load(name)
            profile_phase(torch, dev, model, engine_kw, l_in,
                          ROOT / "build" / "profile")
            del model
            torch.cuda.empty_cache()
        return 0

    rows = kernels_phase(torch, dev)

    model, init_s = load("qwen7b")
    serve = serve_phase(torch, dev, model, init_s)
    pd = pd_phase(torch, dev, model)
    del model                  # free qwen7b before gemma3 loads
    torch.cuda.empty_cache()
    model, init_s = load("gemma3-4b")
    slot = slot_phase(torch, dev, model, init_s)
    del model
    torch.cuda.empty_cache()
    model, init_s = load("mamba2-2.7b")
    mamba = mamba_phase(torch, dev, model, init_s)
    del model
    torch.cuda.empty_cache()
    model, init_s = load("zamba2-7b")
    hybrid = hybrid_phase(torch, dev, model, init_s)
    hybrid_pd = pd_phase(torch, dev, model, "hybrid_pd",
                         dict(ENGINE, page_size=HYBRID_PD_PAGE_SIZE))
    del model
    torch.cuda.empty_cache()
    parity_phase(torch, dev, get_config("qwen7b"))
    slot_parity_phase(torch, dev, get_config("gemma3-4b"), 13, PARITY_L_IN,
                      2e-4, SEED + 6)
    slot_parity_phase(torch, dev, get_config("mamba2-2.7b"), 4,
                      SSM_PARITY_L_IN, SSM_PARITY_TOL, SEED + 8)
    slot_parity_phase(torch, dev, get_config("zamba2-7b"), 7,
                      SSM_PARITY_L_IN, SSM_PARITY_TOL, SEED + 10)

    # launches: the main paths' runs, each with the counts set to 0 just
    # before it (the kernels phase's comparisons are not counted)
    main_paths = {"serve": serve, "pd": pd, "slot": slot, "mamba": mamba,
                  "hybrid": hybrid, "hybrid_pd": hybrid_pd}
    csrc = "src/repro_torch/kernels/csrc"
    kernels = []
    for name, replaces in (
        ("paged_decode_attention", "src/repro/kernels/decode_attention.py:167"),
        ("page_gather", "src/repro/kernels/page_gather.py:35"),
        ("flash_attention", "src/repro/kernels/flash_attention.py:95"),
        ("decode_attention", "src/repro/kernels/decode_attention.py:69"),
        ("ssd", "src/repro/kernels/ssd.py:86"),
        ("rmsnorm", "src/repro/kernels/rmsnorm.py:32"),
    ):
        row = rows[name]
        by_phase = {ph: out["launches"][name] for ph, out in main_paths.items()
                    if out["launches"][name]}
        kernels.append({
            "name": name, "route": "cuda", "source": f"{csrc}/{name}.cu",
            "replaces": replaces, "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    # rmsnorm has no call site in the model (nor in the JAX package's):
    # its 0 launches on the main paths are expected; every other kernel
    # must have run there
    idle = [k["name"] for k in kernels
            if k["launches"] == 0 and k["name"] != "rmsnorm"]
    check(not idle, f"kernels the main paths never launched: {idle}")
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
