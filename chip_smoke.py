#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/kernels/``), then runs twenty-two phases, each printing a JSON
line (``hybrid`` and ``moe`` a second one for their hand-offs,
``parity`` one per model):

1. ``device``  — the card, its power limit and the kernel build time;
   then ``tensor_cores``: for the flash-attention and SSD libraries,
   ptxas's registers and spills of each tensor-core kernel and the
   HGMMA (wgmma) instructions ``cuobjdump -sass`` finds (none, or no
   cuobjdump, fails the run), with the D 80 flash instance's under
   ``d80``: its ptxas report and its HGMMA shapes, failing if any is
   64x128x16 or if P V's widths do not sum to the 80 columns once per
   16 keys; then ``decode_ring``: ptxas's registers
   and spills of each instance of the contiguous decode kernel's ring;
   then ``paged_group``: ptxas's registers and spills of each instance
   of the paged group kernel and the ``HMMA.16816`` (mma.sync)
   instructions ``cuobjdump -sass`` finds in each (an instance without
   one, or a spill, fails the run).
2. ``kernels`` — each kernel against its plain PyTorch version on the
   card (``rtol = atol =`` 2e-5 in f32 with TF32 off, 2e-2 in bf16, the
   gather exactly, SSD 2e-3 in f32 as tests/test_kernels.py holds it)
   at the shapes the main paths give it, plus a ragged and a
   bidirectional flash case, hubert's bidirectional D 80 flash (B 8, 16
   heads, S 1024 and a ragged 1000), ``kv_len == 0`` decode rows, the three
   attention kernels at zamba2's head dim 112, SSD batches with pad
   rows and RMSNorm at mamba2's norm shapes; each timed (device time
   from ``torch.profiler``'s events; the kernel also with CUDA events
   over back-to-back calls) beside its bound, its plain version and a
   PyTorch library call that computes the same function, where one
   exists (none computes SSD); flash attention and SSD also beside
   their CUDA-core instances on the same bf16 inputs (``fma_ms``), the
   contiguous decode kernel beside the split kernel it replaced
   (``legacy_ms``, in turns) at gemma3's, qwen7b's, zamba2's and a GQA-5
   group's (40 / 8 heads) bf16 shapes, with chunks of 128 and 256
   positions at gemma3's (``split_probe_ms``); the paged decode kernel
   at qwen7b's MHA, zamba2's D 112, qwen32b's GQA 40 / 8 and llama70b's
   64 / 8 (``cases.gqa40_8_bf16``, ``cases.gqa64_8_bf16``, beside SDPA
   with ``enable_gqa``), each beside the split kernel in turns
   (``legacy_ms``, ``legacy_event_ms``) and with the route its plan
   takes, and once on NaN in every stale position
   (``cases.gqa40_8_bf16_nan_tail``: finite, and equal to the plain
   version on the same inputs with those positions zeroed).
3. ``serve``   — qwen7b at full width in bf16 (weights drawn on the card
   from a seeded generator) serving 16 Table-1 requests through the
   paged engine; every request must finish with its ``l_out`` tokens,
   the paged decode-attention kernel must have run 32 times per
   C == 1 forward pass and the paged KV write 32 times per paged
   ``chunk_step`` (prefill chunk or decode iteration).
3b. ``decode_graph`` — on the same model, the engine's decode graph
   (every paged decode iteration replayed from one captured CUDA graph)
   against the forced-eager path: 8 requests (prompts of 64 to 900
   tokens, 72 output tokens each) served both ways must give identical
   tokens and launch counts over at least 64 decode iterations, every
   iteration of the graph engine replayed.  Then one K == 1 iteration
   of 8 rows at ~520 positions, both ways in turns: its host time (the
   dispatch's enqueue), its wall time (the profiler's ``dt``) and its
   device time (the kernels' durations from ``torch.profiler``, which
   must see the replayed kernels), and the paged KV write at the decode
   pass's and at a prefill chunk's shape against its bound and its
   plain version (bitwise equal).  ``python3 chip_smoke.py
   --decode-graph`` runs this phase alone (with the kernels' build).
4. ``pd``      — one request prefilled on engine A, exported, evicted and
   imported into engine B: tokens identical to the colocated run, the
   payload size as predicted, the page-gather kernel launched.
5. ``prefix``  — the prefix cache on the same model and engine config:
   16 chat requests over 4 shared 1024-token system prompts (Zipfian
   groups, private suffixes of 1-64 tokens, 32 output tokens) served in
   two waves — the first request of each group, then the other 12 at
   once — with the cache on and off.  Every request must be served, the
   cache must hit, and the prefill tokens saved must equal the hit
   tokens exactly; then a request that hit is handed from a parking
   engine to a second one through ``export_kv`` / ``import_kv`` (its
   table starts with shared pages): tokens equal to the same requests
   served colocated, no cached page referenced after the evict.  The
   paged decode kernel must have run 32 times per C == 1 pass over the
   phase's engines and the page gather twice.  Prints hit tokens,
   prefill tokens, prefill step time (the engine's and CUDA events')
   and the second wave's TTFT with the cache on and off, and the share
   of requests whose tokens match between the two runs (bf16: a near-tie
   may flip where a hit prefills its suffix in other chunks).
6. ``spec``    — SLO-customized speculative decoding on the same model:
   the first 8 ``serve`` requests and 8 prompts tiling a random 24-token
   phrase to 768 tokens (128 output tokens), with speculation on
   (``max_spec_len`` 8) and off.  Every request must be served,
   speculation must have dispatched, no more tokens accepted than
   proposed, the depth histogram summing to the dispatches, and the
   paged decode kernel run 32 times per C == 1 pass (a verify pass is a
   C >= 2 chunk through plain chunk attention, which launches no decode
   kernel).  Prints proposed and accepted tokens, the depth histogram,
   verify-pass and C == 1 pass times, TPOT and decode tok/s on and off,
   and the token match share.
7. ``cluster`` — the port's ``Cluster(backend="engine")`` on full-width
   qwen7b in bf16 (seed weights drawn on the card, offloaded to the
   host and checkpointed under ``build/weights/``, then dropped): 2
   colocated replicas provisioned from the host copy, the HyperFlexis
   policy, the Scaler on (2 to 3 replicas, d2d weights) and the
   H100's latency constants, serving 24 Table-1 requests with Poisson
   arrivals (4 req/s).  First each transport provisions the whole tree
   once and is timed (d2d from replica 0 — twice, the second time into
   the blocks the first freed —, cpu, disk), its copy equal to replica
   0's bit for bit, and the d2d copy decodes a prompt alone to its
   donor's tokens; these probes report to no TLManager, so the Scaler
   starts the run as a deployment would.  Every request must finish
   with its ``l_out`` tokens, the paged decode kernel run 32 times per
   C == 1 pass summed over the replicas, no page gather run, the
   replicas' weights share no storage (two at least still hold
   weights, a scaled-in one none) and the peak memory stay under
   75 GB.  TTFT, TPOT and attainment are read on the cluster's virtual
   clock, which overlaps the replicas' measured steps as if each had a
   card; ``makespan_over_wall`` says how far it ran ahead of this card.
   Every live replica's weights and KV pool must lie on its
   ``WeightManager.placement`` (``cuda:0``: the cluster is given that
   card alone).
8. ``cluster_pd`` — the same traffic on one prefill and one decode
   replica: every request finishes, the page gather runs twice per
   hand-off (K and V pools), the prefill replica runs no C == 1 pass,
   every replica lies on its placement.
8b. ``placement`` — replicas on two devices, the card and the host:
   smoke-width qwen7b ``Cluster``s in f32 (TF32 off; the seed's weights
   drawn on the host and given to each) on ``devices=[cuda:0, cpu]``
   (replica ``wid`` on ``devices[wid % 2]``, as JAX's
   ``WeightManager.placement``), each against the same cluster on
   ``[cpu]``: P/D with the prefill replica on the card and the decode
   replica on the host, and two colocated replicas with a live
   migration of the card replica's residents to the host replica once
   one of them has decoded 4 tokens.
   Every request must finish with the ``[cpu]`` run's tokens (where one
   differs, its top-2 logit margin is printed first), every replica lie
   on its placement, the card replica launch the page gather twice per
   hand-off and the paged decode kernel 2 times per C == 1 pass, the
   host replica nothing, and each kernel call agree with its plain
   version on its own inputs (2e-5, the gather exactly).  Then a d2d
   provision from the card replica to a replica placed on the host,
   bit for bit the donor's.  Prints ``cards`` (the visible cards), the
   replica-to-device map and the card-to-host d2d wall time (the host
   link, not NVLink).
9. ``slot``    — gemma3-4b at full width in bf16 (random weights from a
   seed) serving 16 requests on the slot plane, which the engine picks
   by itself for its sliding-window layers: 12 Table-1 requests and 4
   wikisql prompts longer than the 1024-token window.  Every request
   must finish; flash attention must have run 34 times per prefill
   dispatch and the contiguous decode-attention kernel 5 times (the
   global layers) per C == 1 forward pass.
10. ``mamba``   — mamba2-2.7b at full width in bf16 (random weights from
   a seed) serving the ``serve`` phase's 16 requests on the slot plane
   (``paged=False``): every request must finish, the SSD kernel must
   have run 64 times per prefill dispatch whose padded length is a
   multiple of the 256-token chunk, and no attention kernel at all.
11. ``hybrid``  — zamba2-7b at full width in bf16 serving 8 of those
   requests on its default, paged plane: every request must finish and
   the paged decode kernel (head dim 112) run 13 times, once per shared
   attention invocation, per C == 1 pass; then a P/D hand-off
   (``hybrid_pd``, the ``pd`` checks) to an engine with pages of 32
   whose payload carries 68 layers of SSM/conv slot rows and 13 of
   pages.
12. ``parity`` — f32 with TF32 off, kernel route against plain route on
   the same weights: a 2-layer full-width qwen7b's paged decode logits,
   a 13-layer full-width gemma3 (two local:global groups and a tail)
   prefilling an 1100-token prompt and decoding 8 tokens (logits within
   2e-4), and a 4-layer mamba2 and a 7-layer zamba2 (one 5 + 1 group
   and a tail) prefilling a 1024-token prompt and decoding 8 tokens
   (within 1e-3: the kernel and the plain scan sum the chunked SSD in
   other orders, and the decay ``exp(cum_q - cum_k)`` takes the
   difference of prefix sums that reach the hundreds within a chunk).
13. ``feature_parity`` — f32 with TF32 off, a 2-layer full-width qwen7b:
   the prefix cache on and off over 6 shared-prefix prompts served one
   after another, and speculation on and off over 4 repetitive prompts
   (32 output tokens).  Tokens must be identical; at a divergence the
   plain run's top-2 logit margin there must be under 2e-4 (the
   ``parity`` tolerance), or the phase fails.
14. ``moe``     — olmoe-1b-7b at full width in bf16 (16 layers, d 2048,
   64 experts, top-8; 6.9 B parameters) serving ``serve``'s 16 requests
   on the paged plane: every request must finish, the paged decode
   kernel run 16 times per C == 1 pass and no other kernel (the experts
   are batched GEMMs over a capacity buffer, as in the JAX package).
   Prints the share of dropped expert assignments over the phase's MoE
   calls and the device time of one decode pass's MoE FFN (every
   expert weight read once) against its bound; then ``moe_pd`` (the
   ``pd`` checks) and a ``parity`` line for a 2-layer full-width olmoe
   in f32 (within 2e-4).
15. ``hubert`` — hubert-xlarge at full width in bf16 (48 bidirectional
   encoder layers over frames, d 1280, 16 heads of 80; 1.26 B
   parameters): one ``Model.forward`` over 8 x 1024 random frames, the
   flash kernel exactly 48 times and nothing else, finite logits; its
   wall and device time, flash's device time and share of it, and peak
   memory; then a 2-layer full-width cut
   in f32 (TF32 off), the kernel route against the plain route within
   2e-4.
16. ``train`` — ``TrainRunner`` on full-width hubert-xlarge in f32 (TF32
   off), remat, the plain attention (no kernel has a backward, in
   either package: no kernel may launch), batch 8 x 512 over 2
   micro-batches, 6 steps: every loss and gradient norm finite, no step
   skipped after the first; prints s/step, tokens/s, peak memory and
   model TFLOP/s beside the f32 peak.  Then crash and resume (a
   checkpoint every 2 steps under ``build/train_ckpt/``, a crash after
   3, a resumed run to 6) on hubert cut to 4 layers at full width (a
   1.27 GB checkpoint) and on the smoke qwen2.5-14b: history, final
   parameters and optimizer state equal an uninterrupted run's bit for
   bit, with deterministic algorithms on.
17. ``train_pod`` — the int8 pod-axis gradient sync
   (``distributed/compression.py``).  Full-width hubert-xlarge in f32
   (TF32 off), remat, the plain attention, batch 8 x 512 in one pass (the
   compressed path takes no micro-batches), on a ``(pod 1, data 1,
   model 1)`` ``DeviceMesh`` over a one-rank NCCL group: two plain
   value-and-grads bitwise equal (else the checks hold to one
   quantization step), the compressed loss bitwise equal to the plain
   one and each leaf's gradient equal to ``dequantize(quantize(g))``, 3
   compressed train steps with finite losses, no kernel launched;
   prints s/step compressed and plain, the sync's device ms and payload
   bytes, leaves, collectives and peak memory.  Then two spawned ranks
   sharing ``cuda:0`` over gloo (NCCL refuses two ranks on one device)
   on a 4-layer full-width cut, against the one-process mean over the
   two halves: loss and uncompressed gradients within 1e-5, compressed
   within half a step plus that, both ranks' parameters bitwise equal
   after a step; the gloo sync's wall ms (host-staged).
18. ``qwen32b`` — qwen32b at full width in bf16 (64 layers, d 5120, 40
   heads over 8 KV heads of 128, QKV bias; 32.5 B parameters, 65 GB),
   alone on the card after every other model is freed, serving
   ``serve``'s 16 requests on the paged plane (the ``serve`` checks);
   prints the peak memory of the weights' init and of the serving run;
   then ``qwen32b_decode``: one prefill and two decode blocks of 8 x
   512-token prompts traced as ``--profile`` does, a decode pass's
   device ms and the paged kernel's ms and share of it.
19. ``dryrun`` (run after ``spec``, on its qwen7b) — the meta-device dry
   run (``repro_torch.launch.dryrun``) of three cells on a ``(data 1,
   model 1)`` mesh, then the same cells on their real tensors on the
   card: qwen7b ``prefill`` of 8 x 512 tokens and ``decode_step`` of 8
   rows over a 2048-position cache (bf16, the kernel route), and
   hubert-xlarge's train step over 8 x 512 frames (f32, TF32 off, remat,
   one pass).  For each: the dry run's ``argument_bytes`` beside the
   bytes of the tensors the card's cell allocates (they must be
   equal), the peak memory over a step, the step's device ms, the
   three roofline terms (hubert's compute term against the f32 peak)
   and the measured share ``max(compute, memory term) / device time``,
   which must not pass 1.05: the terms are lower bounds.  Flash and
   decode attention must have launched.
20. ``examples`` (run last) — the port's five examples
   (``examples/*_torch.py``) in this process through ``main(argv)``, on
   the card (their default device), at the JAX package's CI arguments:
   ``quickstart``; ``serve_engine_e2e --n-requests 12 --slots 4`` on
   qwen7b (paged), gemma3-4b (slot plane) and mamba2-2.7b (paged, no
   attention layer: no kernel); ``pd_disaggregated --backend engine
   --smoke`` and ``--smoke`` (sim); ``online_serving --smoke``;
   ``train_small --steps 100`` into a fresh directory under ``build/``,
   then ``--steps 120`` on it.  The examples' own lines go to stderr.
   Each run has the counts set to 0 just before it: every request must
   be served, the kernels of its path (``EXAMPLE_RUNS``) launched and no
   other, and every kernel call of the run (decoded eagerly here: a
   replayed graph calls no Python) agree with the plain version
   on that call's own inputs (f32 at D 16 here: the paged split, the
   CUDA-core flash and the contiguous decode instances, which the
   kernels phase does not reach; 2e-5, the gather exactly); the P/D run
   must make 8 hand-offs, ``train_small``'s loss must stay within 0.05
   of ln(vocab) (its data are uniform random tokens: the loss starts at
   that floor and cannot fall) while its gradient norm falls from step 1
   to step 100 and every parameter tensor of its step-50 and step-100
   checkpoints differs from its start, and its second run resume from
   step 100.  Prints per run its wall seconds, served / total, launches
   and the calls held, and ``train_small``'s s/step, tokens/s, first
   and last loss and gradient norm and how far its parameters moved.

Then it prints the card's ``nvidia-smi`` name and power limit, one JSON
line with every kernel's numbers, and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero; it also exits non-zero, printing no result, when
no CUDA card is visible or when it is run outside the repository.

    python3 chip_smoke.py --flash80-variants [OTHER_CSRC]

instead builds the D 80 flash instance once per variant
(``FLASH80_VARIANTS``: one block per tile in place of the persistent
grid, 64 keys a KV tile, other ring depths, diagnostics that leave out
the exp2 or the warpgroups' turns) and, given the kernel sources of
another checkout, that checkout's flash attention; holds each to the
plain version and times each beside SDPA at hubert's shape, in turns.

    python3 chip_smoke.py --paged-variants

instead times the paged group kernel's launch plan against other
chunks, stages and ring depths (``PAGED_VARIANTS``, ``PAGED_RINGS``)
beside the split kernel and SDPA at four decode shapes, in turns, and
qwen32b's decode passes with the group kernel and with the split
kernel in turns (``paged_e2e``: wall and device ms a pass).

    python3 chip_smoke.py --train-pod

instead runs only the ``train_pod`` phase, with no kernel built (it
launches none).

    python3 chip_smoke.py --dryrun

instead builds the kernels and runs only the ``dryrun`` phase.

    python3 chip_smoke.py --examples

instead builds the kernels and runs only the ``examples`` phase.

    python3 chip_smoke.py --placement

instead builds the kernels and runs only the ``placement`` phase.

    python3 chip_smoke.py --profile

instead traces, with ``torch.profiler``, one prefill step and two
decode blocks of each full-width engine (qwen7b, olmoe-1b-7b and
qwen32b on the paged plane, gemma3-4b and mamba2-2.7b on the slot
plane), writes the gzipped
chrome traces to ``build/profile/`` and prints the device's busy time,
idle share, kernel time by name and the CUDA runtime's synchronize and
memcpy calls for each window.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
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
# cluster phases: 512 pages of KV per replica keep three full-width
# qwen7b replicas and one timed copy under PEAK_LIMIT_BYTES
CLUSTER_ENGINE = dict(ENGINE, n_pages=512)
CLUSTER_QPS, CLUSTER_N_PER_TASK = 4, 6     # 24 Table-1 requests, Poisson
PEAK_LIMIT_BYTES = 75e9
ALONE_ENGINE = dict(n_slots=1, max_len=256, page_size=16, chunk_size=256,
                    decode_block=8)
TRANSPORT_L_IN, TRANSPORT_L_OUT = 128, 16
# placement phase: smoke-width clusters on the card and the host, f32
PLACEMENT_ENGINE = dict(n_slots=4, max_len=64, prefill_batch=2, page_size=8,
                        chunk_size=16)
PLACEMENT_N, PLACEMENT_MIGRATE_L_OUT = 8, 16
PLACEMENT_KICK_TOKENS = 4   # migrate once a card resident has decoded 4
# prefix phase: chat traffic over shared system prompts
PREFIX_N, PREFIX_GROUPS, PREFIX_LEN, PREFIX_SUFFIX, PREFIX_L_OUT = (
    16, 4, 1024, 64, 32)
# spec phase: 8 Table-1 requests + 8 prompts tiling a 24-token phrase
SPEC_N_TABLE1, SPEC_N_REPEAT, SPEC_PHRASE, SPEC_L_IN, SPEC_L_OUT = (
    8, 8, 24, 768, 128)
SPEC_MAX_LEN = 8
# feature_parity phase: the features on and off in f32, 2 layers
FEATURE_ENGINE = dict(n_slots=4, max_len=2048, page_size=16, chunk_size=256)
FEATURE_TOL = 2e-4
# hubert phase: one forward over 8 x 1024 frames (bf16; the parity cut
# in f32 over the same shape)
HUBERT_FRAMES = (8, 1024)
# train phase: full-width hubert-xlarge in f32, 8 x 512 frames over 2
# micro-batches; crash/resume runs of 6 steps, crashing after 3
TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS, RESUME_STEPS = (8, 512), 2, 6, 6
TRAIN_CKPT = ROOT / "build" / "train_ckpt"
# train_pod phase: the int8 pod-axis gradient sync; full-width hubert on
# a 1-pod mesh over TRAIN_BATCH in one pass (the compressed path takes
# no micro-batches), then 2 pods sharing the card (gloo) on a cut
POD_AXES = ("pod", "data", "model")
POD_STEPS, POD_LAYERS, POD_TOL = 3, 4, 1e-5
POD_DIR = ROOT / "build" / "train_pod"
# dryrun phase: the dry run's one-card cells, (batch, positions) each
DRYRUN_PREFILL, DRYRUN_DECODE, DRYRUN_TRAIN = (8, 512), (8, 2048), (8, 512)
DRYRUN_SHARE_MAX = 1.05
# examples phase: the port's examples (examples/*_torch.py) at the JAX
# CI's arguments, in process; each run with the kernels its path must
# launch (no other may).  mamba2-2.7b serves on the paged plane, as in
# the JAX package: it has no attention layer, and each prefill chunk
# carries the SSM state, which the SSD kernel does not take (the hybrid
# phase's rule; JAX's gate is src/repro/models/mamba2.py:262, a chunk
# reaches its Pallas kernel only when ``ssm_state is None``), so it
# launches no kernel: an SSD kernel that takes an initial state would
# change this entry and that rule together.  Training takes the plain
# routes (no kernel has a backward).
E2E_ARGS = ("--n-requests", "12", "--slots", "4")
EXAMPLE_RUNS = (
    ("quickstart", "quickstart_torch", (),
     ("paged_decode_attention", "paged_kv_write")),
    ("serve_engine_e2e qwen7b", "serve_engine_e2e_torch",
     ("--arch", "qwen7b", *E2E_ARGS),
     ("paged_decode_attention", "paged_kv_write")),
    ("serve_engine_e2e gemma3-4b", "serve_engine_e2e_torch",
     ("--arch", "gemma3-4b", *E2E_ARGS),
     ("flash_attention", "decode_attention")),
    ("serve_engine_e2e mamba2-2.7b", "serve_engine_e2e_torch",
     ("--arch", "mamba2-2.7b", *E2E_ARGS), ()),
    ("pd_disaggregated engine", "pd_disaggregated_torch",
     ("--backend", "engine", "--smoke"),
     ("paged_decode_attention", "page_gather", "paged_kv_write")),
    ("pd_disaggregated sim", "pd_disaggregated_torch", ("--smoke",), ()),
    ("online_serving", "online_serving_torch", ("--smoke",),
     ("paged_decode_attention", "paged_kv_write")),
    ("train_small", "train_small_torch", ("--steps", "100"), ()),
    ("train_small resume", "train_small_torch", ("--steps", "120"), ()),
)
EXAMPLE_PD_TRANSFERS = 8
# train_small's data are uniform random tokens (training/data.py), so no
# model's expected loss is below ln(vocab), and the initial model already
# sits there (10.38 at step 1 in both packages): its loss cannot fall.  A
# run that trains stays within this band of ln(vocab) while its gradient
# norm shrinks (the logits flatten toward the uniform optimum).
EXAMPLE_LOSS_BAND = 0.05
# every kernel call of the examples' runs is held against the plain
# version on the same inputs, at the kernels phase's rtol = atol for
# the call's dtype, the gather exactly
EXAMPLE_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# decode_graph phase: 8 requests served with and without the decode
# graph; then K == 1 iterations of 8 rows at GRAPH_TIME_L_IN positions
GRAPH_N, GRAPH_L_IN, GRAPH_L_OUT = 8, (64, 900), 72
GRAPH_TIME_L_IN, GRAPH_TIME_STEPS = 512, 16


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
                     zero_row=False, b=8, d=128, ps=16, mp=128, seed=1,
                     stale=1e3):
    """qwen7b's decode shape (zamba2's with d=112): B=8 slots of up to
    2048 tokens in a pool of B*MP pages of 16 tokens; kv_len drawn from
    [1, 2048].  ``poison`` puts ``stale`` at every position no row
    attends to (NaN included) and -1 past each row's last page."""
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
        k = torch.where(live, k, stale)
        v = torch.where(live, v, stale)
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
        ("gqa64_8_bf16", dict(dtype=torch.bfloat16, hq=64, hkv=8), 2e-2),
        # NaN in the tail of every last page, which the group kernel
        # copies whole, and in every page past kv_len; held to the plain
        # version on the same inputs with those positions zeroed
        ("gqa40_8_bf16_nan_tail", dict(dtype=torch.bfloat16, hq=40, hkv=8,
                                       poison=True, zero_row=True,
                                       stale=float("nan")), 2e-2),
        ("zamba2_d112_bf16", dict(dtype=torch.bfloat16, hq=32, hkv=32,
                                  d=112), 2e-2),
        ("zamba2_d112_f32_poisoned", dict(dtype=torch.float32, hq=32,
                                          hkv=32, d=112, poison=True,
                                          zero_row=True), 2e-5),
    ):
        args = attention_inputs(torch, dev, **kw)
        got = decode_attention.paged_decode_attention(*args)
        clean = [torch.nan_to_num(x, nan=0.0) if x.is_floating_point()
                 else x for x in args]
        want = ref.paged_decode_attention_ref(*clean)
        cases[name] = compare(torch, got, want, tol,
                              f"paged_decode_attention {name}")
        cases[name]["route"] = paged_route(decode_attention, *args)
        if kw.get("zero_row"):
            check(bool((got[0] == 0).all()), f"{name}: kv_len 0 row != 0")

    def paged_timing(d, hq=32, hkv=32):
        """Timing at the main path's decode shape and dtype (qwen32b's
        GQA 40 / 8 with ``hq``, ``hkv``), beside the split kernel in
        turns on the same inputs (``legacy_ms``, ``legacy_event_ms``)."""
        q, k, v, table, kv_len = attention_inputs(
            torch, dev, dtype=torch.bfloat16, hq=hq, hkv=hkv, d=d)
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

        def kernel(**kw):
            return lambda: decode_attention.paged_decode_attention(
                q, k, v, table, kv_len, **kw)

        want = ref.paged_decode_attention_ref(q, k, v, table, kv_len)
        legacy = compare(torch, kernel(legacy=True)(), want, 2e-2,
                         f"paged_decode_attention split D {d} {hq}/{hkv}")
        ms, legacy_ms = ab_ms(torch, kernel(), kernel(legacy=True))
        event_ms, legacy_event_ms = ab_ms(
            torch, kernel(), kernel(legacy=True),
            timer=lambda fn: cuda_ms(torch, fn, 50))
        return {
            "ms": ms, "legacy_ms": legacy_ms,
            "legacy_max_abs_err": legacy["max_abs_err"],
            "plain_ms": device_ms(torch, lambda: ref.paged_decode_attention_ref(
                q, k, v, table, kv_len)),
            "library_ms": device_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], kc, vc, attn_mask=mask,
                enable_gqa=hq != hkv)),
            "event_ms": event_ms, "legacy_event_ms": legacy_event_ms,
            "route": paged_route(decode_attention, q, k, v, table, kv_len),
            **bound_row(att_bytes, att_flops, BF16_FLOPS_PER_S),
            "shape": {"B": b, "Hq": hq, "Hkv": hkv, "D": d, "ps": ps,
                      "MP": table.shape[1], "sum_kv_len": int(lens.sum()),
                      "dtype": "bfloat16"},
        }

    att = {**paged_timing(128),
           "max_abs_err": cases["mha_bf16"]["max_abs_err"]}
    cases["zamba2_d112_bf16"].update(paged_timing(112))
    cases["gqa40_8_bf16"].update(paged_timing(128, hq=40, hkv=8))
    cases["gqa64_8_bf16"].update(paged_timing(128, hq=64, hkv=8))
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
    return {"paged_decode_attention": {**att, "cases": cases},
            "page_gather": gat,
            "flash_attention": flash, "decode_attention": dec, "ssd": ssd,
            "rmsnorm": norm}


def paged_route(decode_attention, q, k, v, table, kv_len) -> dict:
    """The route and launch plan ``paged_plan`` gives these inputs."""
    plan = decode_attention.paged_plan(
        q.shape[0], q.shape[1], k.shape[1], table.shape[1], k.shape[2],
        q.shape[2], q.dtype)
    return {"kernel": plan.route, "n_split": plan.n_split,
            "chunk_pages": plan.chunk_pages, "stage_pages": plan.stage_pages}


PAGED_GROUP_KERNEL = "paged_group_kernel"   # the group kernel's function


def paged_group_report(_build) -> dict:
    """ptxas's registers and spills of each instance of the paged group
    kernel (bf16 at head dim D) and its ``HMMA.16816`` (mma.sync
    m16n8k16) instructions per function in ``cuobjdump -sass``.  Fails
    if an instance holds no HMMA.16816 or ptxas reports a spill."""
    sass = subprocess.run(
        [_build.cuda_tool("cuobjdump"), "-sass",
         str(_build.library_path("paged_decode_attention"))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    hmma: dict[str, int] = {}
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            if PAGED_GROUP_KERNEL in fn:
                hmma.setdefault(fn, 0)
        elif fn and PAGED_GROUP_KERNEL in fn and re.search(r"\bHMMA\.16816",
                                                          line):
            hmma[fn] += 1
    check(bool(hmma) and all(hmma.values()),
          f"a {PAGED_GROUP_KERNEL} function holds no HMMA.16816: {hmma}")

    def instance(fn):
        m = re.search(PAGED_GROUP_KERNEL + r"ILi(\d+)E", fn)
        return m and f"bf16 D{m.group(1)}"

    ptxas, notes = ptxas_report(
        _build.build_log.get("paged_decode_attention", ""), instance)
    spills = {k: v for k, v in ptxas.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    check(not spills, f"{PAGED_GROUP_KERNEL} spills: {spills}")
    return {"ptxas": ptxas or "built earlier: no ptxas report",
            "ptxas_notes": notes, "hmma_16816_by_function": hmma}


def ptxas_report(log: str, wanted) -> tuple[dict, list]:
    """What ptxas said (the -Xptxas -v build log) of each kernel whose
    mangled name ``wanted`` maps to a key (None: skipped): registers,
    stack and spill bytes; and any C75xx performance note."""
    ptxas: dict[str, dict] = {}
    notes = []
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = wanted(m.group(1))
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
    return ptxas, notes


def tensor_core_report(_build) -> dict:
    """For each redesigned library (flash attention, SSD): what ptxas
    said of each tensor-core kernel (``ptxas_report``) and the HGMMA
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
        ptxas, notes = ptxas_report(
            _build.build_log.get(name, ""),
            lambda fn: fn if re.search(r"_(tc|cb)_kernel|" + D80_KERNEL, fn)
            else None)
        out[name] = {"hgmma": sum(hgmma.values()), "hgmma_by_function": hgmma,
                     "ptxas": ptxas or "built earlier: no ptxas report",
                     "ptxas_notes": notes}
    # hubert's head dim: the D 80 instance, 64 + 16 columns
    flash = out["flash_attention"]["ptxas"]
    out["flash_attention"]["d80"] = {
        "ptxas": ({fn: v for fn, v in flash.items() if D80_KERNEL in fn}
                  if isinstance(flash, dict) else flash),
        **d80_hgmma(_build.library_path("flash_attention"), cuobjdump)}
    return out


D80_KERNEL = "flash80_kernel"   # the D 80 instance's function


def d80_hgmma(lib, cuobjdump, strict: bool = True) -> dict:
    """The wgmma shapes (``HGMMA.64xNx16``) of the D 80 flash function in
    ``cuobjdump -sass`` of ``lib``: QK^T at n 64 per 64 keys, P V at
    n 64 + n 16 per 16 keys (V the transposed B).  Fails if any is
    64x128x16 (PV over a tile padded to 128 columns), or if the P V
    widths do not cover the 80 columns once per 16 keys: each width as
    often as the others, the widths summing to 80.  ``strict=False``
    reports without checking."""
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    shapes: Counter = Counter()
    pv: Counter = Counter()
    forms: Counter = Counter()
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = fn and D80_KERNEL in fn and re.search(r"HGMMA\.64x(\d+)x16[^;]*",
                                                   line)
        if m:
            n = int(m.group(1))
            shapes[n] += 1
            # P V: B (V) MN-major, which the SASS marks as transposed
            if "tnspB" in m.group(0):
                pv[n] += 1
            forms[re.sub(r"\d+", "#", m.group(0))] += 1
    if strict:
        check(bool(shapes), f"no HGMMA in the {D80_KERNEL} function")
        check(128 not in shapes, f"{D80_KERNEL} runs HGMMA.64x128x16: "
                                 f"{dict(shapes)}")
        check(bool(pv) and len(set(pv.values())) == 1 and sum(pv) == 80,
              f"{D80_KERNEL}'s P V widths {dict(pv)} do not sum to 80 per "
              f"16 keys")
    return {"hgmma_shapes": {f"64x{n}x16": c for n, c in sorted(shapes.items())},
            "pv_widths": {str(n): c for n, c in sorted(pv.items())},
            "pv_columns_per_16_keys": sum(pv), "sass_forms": dict(forms)}


def decode_ring_report(_build) -> dict:
    """ptxas's report of each instance of the contiguous decode kernel's
    ring (dtype, head dim D, query heads per block NG)."""
    def instance(fn):
        m = re.search(r"decode_ring_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E",
                      fn)
        return m and (f"{'f32' if m.group(1) == 'f' else 'bf16'} "
                      f"D{m.group(2)} NG{m.group(3)}")

    ptxas, notes = ptxas_report(_build.build_log.get("decode_attention", ""),
                                instance)
    return {"ptxas": ptxas or "built earlier: no ptxas report",
            "ptxas_notes": notes}


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


def device_ms(torch, fn, iters: int = 5, only: str | None = None):
    """Device time of one call of ``fn``: the durations of what it runs
    on the card, from ``torch.profiler``'s events over ``iters`` calls,
    summed and divided by ``iters``; with ``only``, the pair (that time,
    the time of the kernels whose names hold ``only``).  Unlike
    ``cuda_ms`` it leaves out the host's gaps between launches, which
    dominate calls of a few tens of microseconds.  The tracer now and then hands back a window
    with some or all of its device events missing (seen for library
    calls that record fine in other runs, and once for two of five
    flash-attention calls), and losing events only ever shortens the
    sum: so two windows are traced and the one with more device events
    is kept, and a third is traced if neither has any before the run
    fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best_n, best_us, best_only_us = 0, 0.0, 0.0
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if len(events) > best_n:
            best_n = len(events)
            best_us = sum(e.time_range.elapsed_us() for e in events)
            best_only_us = sum(e.time_range.elapsed_us() for e in events
                               if only is not None and only in e.name)
        if attempt >= 1 and best_n > 0:
            break
    check(best_n > 0, "the profiler recorded no device time in three windows")
    if only is not None:
        return best_us / 1e3 / iters, best_only_us / 1e3 / iters
    return best_us / 1e3 / iters


def flash_pairs(s: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one (b, head) of flash attention."""
    q = np.arange(s)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(s, int)
    hi = q + 1 if causal else np.full(s, s)
    return int((hi - lo).sum())


def flash_kernel_rows(torch, dev):
    """Flash attention against its plain version at gemma3's prefill
    shape (global and local layers), qwen7b's and hubert's (bidirectional,
    D 80: 8 x 1024 frames, and a ragged 1000), ragged S, narrow windows
    and bidirectional cases in both dtypes (bf16 on the tensor-core
    instance, f32 on the CUDA-core one); timed at gemma3's local-layer
    shape, which 29 of its 34 layers run, at zamba2's D 112 and at
    hubert's two bf16 shapes, beside the CUDA-core instance on the same
    bf16 inputs (``fma_ms``)."""
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
        ("hubert_d80_bf16", (8, 16, 16, 1024, 80), False, 0, bf16, 2e-2),
        ("hubert_d80_ragged1000_bf16", (8, 16, 16, 1000, 80), False, 0,
         bf16, 2e-2),
        ("hubert_d80_ragged300_f32", (2, 16, 16, 300, 80), False, 0, f32,
         2e-5),
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
                        "zamba2_d112_bf16", "hubert_d80_bf16",
                        "hubert_d80_ragged1000_bf16"):
            continue
        pos = torch.arange(s, device=dev)
        band = None                  # bidirectional: every key
        if causal:
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


# Variants of the D 80 flash instance, each an edit (old, new) of
# flash_attention.cu: the launch shape and tile sizes it was tuned over,
# and diagnostics that leave out one part of the design (these compute
# something else, or the same in another order, and are timed only).
FLASH80_VARIANTS = {
    "shipped": {"edits": []},
    "one_block_per_tile": {"edits": [
        ("const int grid = n_tiles < sms ? n_tiles : sms;",
         "const int grid = n_tiles;")]},
    "bk64_s4": {"edits": [("constexpr int kBK = 128;", "constexpr int kBK = 64;")]},
    "bk64_s8": {"edits": [("constexpr int kBK = 128;", "constexpr int kBK = 64;"),
                          ("constexpr int kStages = 4;",
                           "constexpr int kStages = 8;")]},
    "bk128_s3": {"edits": [("constexpr int kStages = 4;",
                            "constexpr int kStages = 3;")]},
    "diag_no_ex2": {"diagnostic": True, "edits": [
        ("s[i] = hk::ex2(fmaf(s[i], scale_log2, -mh[h]));",
         "s[i] = fmaf(s[i], scale_log2, -mh[h]);")]},
    "diag_no_turns": {"diagnostic": True, "edits": [
        ("hk::named_sync(turn, 256);", ""),
        ("hk::named_arrive(next, 256);", ""),
        ("if (wg == 1) hk::named_arrive(kTurn, 256);", "")]},
}


def flash80_variants(torch, dev, other_csrc: Path | None = None) -> dict:
    """``--flash80-variants``: the D 80 flash instance built once per
    entry of ``FLASH80_VARIANTS`` (one block per tile in place of the
    persistent grid, 64 keys a KV tile, other ring depths, diagnostics),
    all with ``nvcc`` at once into ``build/flash80_variants/``; each but
    the diagnostics held to the plain version on the edge shapes of the
    cuda tests (2e-2), then timed at hubert's shape (B 8, 16 heads, S
    1024, bidirectional) and a ragged S 1000 beside SDPA, in turns over
    3 rounds (the order reversed every other round); ptxas's report and
    the HGMMA shapes of each.
    ``other_csrc``, the ``csrc`` directory of another checkout (another
    commit's kernels, same C entry point), adds its flash attention as
    the variant ``other``, built from its own sources."""
    import ctypes

    import torch.nn.functional as F

    from repro_torch.kernels import _build, ref

    out_dir = ROOT / "build" / "flash80_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.cuda_tool("nvcc")
    variants = dict(FLASH80_VARIANTS)
    if other_csrc is not None:
        variants["other"] = {"csrc": other_csrc.resolve(), "edits": []}
    procs = {}
    for label, spec in variants.items():
        csrc = spec.get("csrc", _build.CSRC)
        text = (csrc / "flash_attention.cu").read_text()
        for old, new in spec["edits"]:
            check(old in text, f"variant {label}: {old!r} not in the source")
            text = text.replace(old, new)
        src = out_dir / f"{label}.cu"
        src.write_text(text)
        procs[label] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(csrc),
             "-o", str(out_dir / f"{label}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {label: p.communicate()[0] for label, p in procs.items()}
    for label, p in procs.items():
        check(p.returncode == 0, f"variant {label} failed to build:\n"
                                 f"{logs[label]}")
    cuobjdump = _build.cuda_tool("cuobjdump")
    fns, report = {}, {}
    for label in variants:
        lib = ctypes.CDLL(str(out_dir / f"{label}.so"))
        fn = lib.flash_attention_launch
        fn.argtypes = _build.SIGNATURES["flash_attention"][1]
        fn.restype = ctypes.c_int
        fns[label] = fn
        ptxas, notes = ptxas_report(
            logs[label], lambda f: f if D80_KERNEL in f else None)
        report[label] = {"ptxas": ptxas, "ptxas_notes": notes,
                         **d80_hgmma(out_dir / f"{label}.so", cuobjdump,
                                     strict=False)}

    def run(fn, q, k, v, causal, window):
        o = torch.empty_like(q)
        b, hq, s, d = q.shape
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1,
                 b, hq, k.shape[1], s, d, int(causal), window,
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"launch failed: cudaError_t {err}")
        return o

    def inputs(b, hq, hkv, s, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                for shape in ((b, hq, s, 80), (b, hkv, s, 80),
                              (b, hkv, s, 80))]

    cases = [(b, hq, hkv, s, causal, window)
             for b, hq, hkv, s, causal, window in (
                 (2, 16, 16, 1024, False, 0), (1, 16, 16, 1000, False, 0),
                 (4, 16, 16, 1024, False, 0), (1, 8, 4, 1100, True, 0),
                 (1, 8, 2, 700, True, 0), (1, 4, 4, 300, True, 40),
                 (1, 4, 4, 300, False, 40))] + [
        (1, 4, 4, s, causal, 0) for s in (1, 15, 16, 63, 64, 65, 127, 128,
                                          129, 257) for causal in (False, True)]
    checked = {label: fn for label, fn in fns.items()
               if not variants[label].get("diagnostic")}
    errs = {label: 0.0 for label in checked}
    for i, (b, hq, hkv, s, causal, window) in enumerate(cases):
        q, k, v = inputs(b, hq, hkv, s, 100 + i)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        for label, fn in checked.items():
            got = run(fn, q, k, v, causal, window)
            errs[label] = max(errs[label], compare(
                torch, got, want, 2e-2,
                f"{label} {(b, hq, hkv, s, causal, window)}")["max_abs_err"])
    times = {}
    for shape in ((8, 16, 16, 1024), (8, 16, 16, 1000)):
        q, k, v = inputs(*shape, 7)
        calls = {label: (lambda fn=fn: run(fn, q, k, v, False, 0))
                 for label, fn in fns.items()}
        calls["sdpa"] = lambda: F.scaled_dot_product_attention(q, k, v)
        got = {label: [] for label in calls}
        order = list(calls)
        for r in range(3):
            for label in order if r % 2 == 0 else order[::-1]:
                got[label].append(device_ms(torch, calls[label]))
        flops = 4 * shape[0] * shape[1] * 80 * flash_pairs(shape[3], False, 0)
        times[f"S{shape[3]}"] = {
            "bound_ms": bound_row(0, flops, BF16_FLOPS_PER_S)["bound_ms"],
            **{label: {"ms": sum(t) / len(t), "rounds": t}
               for label, t in got.items()}}
    return {"phase": "flash80_variants",
            "variants": {label: {k: str(v) if k == "csrc" else v
                                 for k, v in spec.items()}
                         for label, spec in variants.items()},
            "max_abs_err": errs, "times": times, "report": report}


# --paged-variants: ring depths other than the source's 3 (the stage
# capped at 64 tokens where 4 stages of 128 would not fit), as edits of
# paged_decode_attention.cu; and (ring, chunk pages, stage pages) at ps 16
PAGED_RINGS = {
    2: [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    4: [("constexpr int kStages = 3;", "constexpr int kStages = 4;"),
        ("constexpr int kMaxStageTokens = 128;",
         "constexpr int kMaxStageTokens = 64;")],
}
PAGED_VARIANTS = ((3, 16, 4), (3, 32, 2), (3, 24, 4), (3, 48, 4), (3, 64, 4),
                  (2, 32, 4), (4, 32, 2), (4, 16, 2))


def paged_variants(torch, dev) -> dict:
    """``--paged-variants``: the paged group kernel's launch plan (as
    the model runs it) against other chunks and stages of the source's
    3-stage ring (the C entry point called with them) and against rings
    of 2 and 4 stages (``PAGED_RINGS``, built with ``nvcc`` into
    ``build/paged_variants/``), each held to the plain version (2e-2),
    then timed at qwen32b's GQA 40 / 8, llama70b's 64 / 8, qwen7b's MHA
    and zamba2's D 112 beside the split kernel and SDPA, in turns over 4
    rounds (the order reversed every other round); the merge kernel's
    share of the plan's time.  Then ``paged_e2e``."""
    import ctypes

    import torch.nn.functional as F

    from repro_torch.kernels import _build, decode_attention, ref

    out_dir = ROOT / "build" / "paged_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for ring, edits in PAGED_RINGS.items():
        text = (_build.CSRC / "paged_decode_attention.cu").read_text()
        for old, new in edits:
            check(old in text, f"ring {ring}: {old!r} not in the source")
            text = text.replace(old, new)
        (out_dir / f"r{ring}.cu").write_text(text)
        procs[ring] = subprocess.Popen(
            [_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-I",
             str(_build.CSRC), "-o", str(out_dir / f"r{ring}.so"),
             str(out_dir / f"r{ring}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    name, argtypes = _build.SIGNATURES["paged_decode_attention"]
    libs = {3: _build.library("paged_decode_attention")}
    for ring, proc in procs.items():
        log = proc.communicate()[0]
        check(proc.returncode == 0, f"ring {ring} failed to build:\n{log}")
        libs[ring] = ctypes.CDLL(str(out_dir / f"r{ring}.so"))
        getattr(libs[ring], name).argtypes = argtypes
        getattr(libs[ring], name).restype = ctypes.c_int

    def group(ring, chunk_pages, stage_pages, q, k, v, table, kv_len):
        b, hq, d = q.shape
        n_pages, hkv, ps, _ = k.shape
        mp = table.shape[1]
        n_split = -(-mp // chunk_pages)
        ws = torch.empty((b, hq, n_split, d + 2), dtype=torch.float32,
                         device=dev)
        out = torch.empty_like(q)
        err = getattr(libs[ring], name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
            kv_len.data_ptr(), ws.data_ptr(), out.data_ptr(), 1, b, hq, hkv,
            d, n_pages, ps, mp, n_split, chunk_pages, stage_pages,
            torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"ring {ring} c{chunk_pages} s{stage_pages}: "
                        f"cudaError_t {err}")
        return out

    shapes = {}
    for label, hq, hkv, d in (("gqa40_8", 40, 8, 128), ("gqa64_8", 64, 8, 128),
                              ("mha", 32, 32, 128), ("d112", 32, 32, 112)):
        q, k, v, table, kv_len = attention_inputs(
            torch, dev, dtype=torch.bfloat16, hq=hq, hkv=hkv, d=d)
        want = ref.paged_decode_attention_ref(q, k, v, table, kv_len)
        kc, vc = ref.paged_gather(k, table), ref.paged_gather(v, table)
        mask = (torch.arange(kc.shape[2], device=dev)[None, :]
                < kv_len[:, None].long())[:, None, None, :]
        fns = {"plan": lambda: decode_attention.paged_decode_attention(
            q, k, v, table, kv_len)}
        for ring, c, st in PAGED_VARIANTS:
            fns[f"r{ring}_c{c}_s{st}"] = (
                lambda ring=ring, c=c, st=st:
                group(ring, c, st, q, k, v, table, kv_len))
        for lbl, fn in fns.items():
            compare(torch, fn(), want, 2e-2, f"paged {label} {lbl}")
        fns["split"] = lambda: decode_attention.paged_decode_attention(
            q, k, v, table, kv_len, legacy=True)
        fns["sdpa"] = lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], kc, vc, attn_mask=mask, enable_gqa=hq != hkv)
        times: dict[str, list] = {lbl: [] for lbl in fns}
        for rnd in range(4):
            for lbl in (list(fns) if rnd % 2 == 0 else list(fns)[::-1]):
                times[lbl].append(device_ms(torch, fns[lbl]))
        lens = kv_len.cpu().numpy().astype(np.int64)
        shapes[label] = {
            "ms": {lbl: float(np.mean(t)) for lbl, t in times.items()},
            "merge_ms": device_ms(torch, fns["plan"], only="merge")[1],
            "route": paged_route(decode_attention, q, k, v, table, kv_len),
            **bound_row(int(lens.sum()) * hkv * d * 2 * q.element_size(), 0,
                        BF16_FLOPS_PER_S)}
        del kc, vc
        torch.cuda.empty_cache()
    return {"phase": "paged_variants", "shapes": shapes}


def paged_e2e(torch, dev) -> dict:
    """qwen32b at full width serving 8 x 512-token prompts: decode blocks
    of 8 passes with the paged group kernel and with the split kernel
    (``legacy=True`` put under the model's call), in turns group, split,
    split, group; each turn one block on the host's clock (wall ms a
    pass, synchronized) and one traced (device busy ms a pass, the
    decode-attention kernels' ms a pass, idle share)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.request import Request
    from repro_torch.kernels import decode_attention, ops
    from repro_torch.models.build import Model
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    class Split:
        """The decode-attention module with the paged call on the split
        kernel."""
        def __getattr__(self, attr):
            return getattr(decode_attention, attr)

        @staticmethod
        def paged_decode_attention(*args):
            return decode_attention.paged_decode_attention(*args, legacy=True)

    model = Model(get_config("qwen32b"), dtype=torch.bfloat16, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(SEED))
    engine = InferenceEngine(model, EngineConfig(**ENGINE))
    rng = np.random.default_rng(SEED + 4)
    for i in range(ENGINE["n_slots"]):
        prompt = rng.integers(0, model.cfg.vocab_size, 512).astype(np.int32)
        engine.submit(Request.from_prompt(i, prompt, 80))
    while engine.queue or engine.prefilling:
        engine.step()
    engine.step()                 # first full-batch decode block
    turns: dict[str, dict] = {"group": {}, "split": {}}
    for mode in ("group", "split", "split", "group"):
        ops._decode = Split() if mode == "split" else decode_attention
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev = engine.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(ev["kind"] == "decode", f"e2e: a {ev['kind']} step")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                ev2 = engine.step()
                torch.cuda.synchronize()
                wall2 = time.perf_counter() - t1
        finally:
            ops._decode = decode_attention
        path = ROOT / "build" / "profile" / f"trace_e2e_{mode}.json.gz"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        tr = trace_summary(path, wall2)
        for key, val in (
                ("wall_ms_per_pass", 1e3 * wall / ev["k"]),
                ("device_ms_per_pass", tr["busy_ms"] / ev2["k"]),
                ("paged_ms_per_pass",
                 tr["decode_attention_ms"]["ms"] / ev2["k"]),
                ("idle_share", tr["idle_share"])):
            turns[mode].setdefault(key, []).append(val)
    del engine, model
    torch.cuda.empty_cache()
    return {"phase": "paged_e2e", "model": "qwen32b",
            "requests": f"{ENGINE['n_slots']} x (512 in, 80 out)",
            **{mode: {k: float(np.mean(v)) for k, v in t.items()}
               for mode, t in turns.items()},
            "turns": turns}


def ab_ms(torch, a, b, timer=None) -> tuple[float, float]:
    """Times of two functions measured in turns a, b, b, a on one card
    (``device_ms`` each, or ``timer``): the mean of each function's two."""
    timer = timer or (lambda fn: device_ms(torch, fn))
    a1, b1, b2, a2 = (timer(f) for f in (a, b, b, a))
    return (a1 + a2) / 2, (b1 + b2) / 2


def decode_kernel_rows(torch, dev):
    """Contiguous decode attention against its plain version at gemma3's
    decode shape (8 slots of up to 2048 tokens, GQA 8/4, D 256, one
    ``kv_len == 0`` row), qwen7b's MHA shape, zamba2's D 112 and a GQA-5
    group (40 / 8 heads at D 128, as in qwen2.5-14b); timed at each bf16
    shape beside the split kernel it replaced
    (``legacy_ms``, and ``legacy_event_ms`` beside ``event_ms``, each in
    turns on the same inputs), and at gemma3's with chunks of 128 and 256
    positions (``split_probe_ms``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, ref

    bf16, f32 = torch.bfloat16, torch.float32
    timed = ("gemma3_bf16_kvlen0", "qwen7b_mha_bf16",
             "zamba2_d112_bf16_kvlen0", "qwen_gqa5_bf16")
    cases = {}
    for name, (b, hq, hkv, s, d), dt, tol in (
        ("gemma3_bf16_kvlen0", (8, 8, 4, 2048, 256), bf16, 2e-2),
        ("gemma3_f32_kvlen0", (8, 8, 4, 2048, 256), f32, 2e-5),
        ("qwen7b_mha_bf16", (8, 32, 32, 2048, 128), bf16, 2e-2),
        ("zamba2_d112_bf16_kvlen0", (8, 32, 32, 2048, 112), bf16, 2e-2),
        ("zamba2_d112_f32_kvlen0", (8, 32, 32, 2048, 112), f32, 2e-5),
        ("qwen_gqa5_bf16", (8, 40, 8, 2048, 128), bf16, 2e-2),
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
        if name not in timed:
            continue

        def kernel(**kw):
            return lambda: decode_attention.decode_attention(q, k, v, kv_len,
                                                             **kw)

        old = decode_attention.decode_attention(q, k, v, kv_len, legacy=True)
        legacy = compare(torch, old, want, tol, f"decode {name} legacy")
        mask = (torch.arange(s, device=dev)[None, :]
                < kv_len[:, None].long())[:, None, None, :]
        n_bytes = (int(lens.sum()) * hkv * d * 2 * q.element_size()
                   + 2 * q.numel() * q.element_size() + 4 * b)
        flops = 4 * int(lens.sum()) * hq * d
        ms, legacy_ms = ab_ms(torch, kernel(), kernel(legacy=True))
        event_ms, legacy_event_ms = ab_ms(
            torch, kernel(), kernel(legacy=True),
            timer=lambda fn: cuda_ms(torch, fn, 50))
        cases[name].update(
            ms=ms, legacy_ms=legacy_ms,
            legacy_max_abs_err=legacy["max_abs_err"],
            plain_ms=device_ms(torch, lambda: ref.decode_attention_ref(
                q, k, v, kv_len)),
            library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], k, v, attn_mask=mask, enable_gqa=True)),
            event_ms=event_ms, legacy_event_ms=legacy_event_ms,
            **bound_row(n_bytes, flops, BF16_FLOPS_PER_S),
            shape={"B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d,
                   "sum_kv_len": int(lens.sum()), "dtype": "bfloat16"})
        if name == "gemma3_bf16_kvlen0":
            t128, t256 = ab_ms(torch, kernel(split_tokens=128),
                               kernel(split_tokens=256))
            cases[name]["split_probe_ms"] = {"128": t128, "256": t256}
        del old, mask
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


PAGED_KERNELS = ("paged_decode_attention", "paged_kv_write")


def paged_passes(engine) -> int:
    """Paged ``chunk_step`` passes the engine ran, each of which writes
    K/V once per attention layer: a C == 1 pass per decode iteration,
    and one per other dispatch (a prefill chunk or a verify pass)."""
    return (c1_passes(engine) + engine.n_dispatches
            - sum(engine.decode_block_hist.values()))


def serve_phase(torch, dev, model, init_s: float, phase: str = "serve",
                **extra):
    """``serve``'s 16 requests on the paged plane (qwen7b; ``qwen32b``
    the same on qwen32b): every request served, the paged decode kernel
    once per layer and C == 1 pass, no other kernel."""
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    cfg = model.cfg
    engine = InferenceEngine(model, EngineConfig(**ENGINE))
    check(engine.paged, f"{phase}: the engine did not take the paged plane")
    reqs = table1_requests(cfg.vocab_size)
    out = drive(torch, engine, reqs, phase)
    launches, passes = out["launches"], out["c1_passes"]
    check(launches["paged_decode_attention"] == cfg.n_layers * passes,
          f"decode-attention launches {launches['paged_decode_attention']}"
          f" != {cfg.n_layers} x {passes} C==1 passes")
    writes = cfg.n_layers * paged_passes(engine)
    check(launches["paged_kv_write"] == writes,
          f"paged KV writes {launches['paged_kv_write']} != {writes}")
    others = {k: n for k, n in launches.items()
              if k not in PAGED_KERNELS and n}
    check(not others, f"the {phase} phase ran other kernels: {others}")
    out.update(engine=ENGINE, init_s=init_s, **c1_pass_times(out), **extra)
    emit(out)
    del engine
    torch.cuda.empty_cache()
    return out


def graph_requests(vocab: int, n: int = GRAPH_N, l_in=GRAPH_L_IN,
                   l_out: int = GRAPH_L_OUT) -> list:
    """``n`` requests with prompts of ``l_in`` tokens (a fixed length, or
    spread over a (low, high) range) and ``l_out`` output tokens."""
    from repro_torch.core.request import Request

    rng = np.random.default_rng(SEED + 11)
    lens = (np.full(n, l_in) if isinstance(l_in, int)
            else np.linspace(*l_in, n).astype(int))
    return [Request.from_prompt(
        i, rng.integers(0, vocab, int(m)).astype(np.int32), l_out)
        for i, m in enumerate(lens)]


def graph_iteration_times(torch, model, eager: bool) -> dict:
    """One K == 1 decode iteration of ``GRAPH_N`` rows at
    ``GRAPH_TIME_L_IN`` positions, as the engine dispatches it (graph or
    forced-eager): its host enqueue and wall ``dt`` from the engine's
    spans, and its device time from ``torch.profiler``'s kernels over
    ``GRAPH_TIME_STEPS`` iterations (with their count, so that a trace
    that misses the replayed kernels shows), and the paged decode
    attention call's share of it."""
    import contextlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import tracing
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    engine = InferenceEngine(model, EngineConfig(**dict(ENGINE,
                                                        decode_block=1)))
    reqs = graph_requests(model.cfg.vocab_size, l_in=GRAPH_TIME_L_IN,
                          l_out=4 * GRAPH_TIME_STEPS)
    for r in reqs:
        engine.submit(r)
    ctx = engine_mod._forced_eager() if eager else contextlib.nullcontext()
    with ctx:
        while engine.queue or engine.prefilling:
            engine.step()
        for _ in range(2):
            engine.step()             # the graph captured, caches warm
        tracing.enable()
        try:
            evs = [engine.step() for _ in range(GRAPH_TIME_STEPS)]
            spans = tracing.drain()
        finally:
            tracing.disable()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(GRAPH_TIME_STEPS):
                engine.step()
            torch.cuda.synchronize()
    check(all(e["kind"] == "decode" and e["k"] == 1
              and e["graph"] is not eager for e in evs),
          f"decode_graph: the timed steps were not K == 1 decode steps of "
          f"the {'eager' if eager else 'graph'} path: {evs}")
    dispatch = [1e3 * (sp.end - sp.start) for sp in spans
                if sp.name == "engine.dispatch"]
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {"host_enqueue_ms": float(np.mean(dispatch)),
           "wall_ms": 1e3 * float(np.mean([e["time"] for e in evs])),
           "device_ms": sum(e.time_range.elapsed_us() for e in events)
           / 1e3 / GRAPH_TIME_STEPS,
           "device_ops_per_iteration": len(events) / GRAPH_TIME_STEPS,
           "paged_kernel_ops": sum("paged_group_kernel" in e.name
                                   for e in events) / GRAPH_TIME_STEPS,
           # one paged decode attention call (its kernel and merge)
           "paged_call_ms": sum(e.time_range.elapsed_us() for e in events
                                if "paged_group_kernel" in e.name
                                or "decode_merge_kernel" in e.name)
           / 1e3 / GRAPH_TIME_STEPS / model.n_attn}
    del engine
    torch.cuda.empty_cache()
    return out


def kv_write_timing(torch, dev, model) -> dict:
    """The paged KV write at qwen7b's decode pass (8 rows, one lane
    each) and at a prefill chunk's shape (8 x 256 lanes, 174 of them
    real): device time beside its bound and its plain version's, the
    two bitwise equal."""
    from repro_torch.kernels import ops, ref

    cfg = model.cfg
    h, d = model.n_kv_eff, cfg.resolved_head_dim
    n_pages, ps, mp = 1024, ENGINE["page_size"], 128
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    pools = [torch.randn(n_pages, h, ps, d, generator=g, device=dev)
             .to(model.dtype) for _ in range(2)]
    table = torch.randperm(n_pages, generator=g, device=dev).int()
    table = table[:8 * mp].reshape(8, mp).contiguous()
    out = {}
    for label, c, lens in (("decode", 1, [1] * 8),
                           ("prefill_chunk", ENGINE["chunk_size"],
                            [64, 48, 40, 22, 0, 0, 0, 0])):
        start = torch.tensor([500 + 37 * i for i in range(8)],
                             dtype=torch.int32, device=dev)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        k_new, v_new = (torch.randn(8, c, h, d, generator=g, device=dev)
                        .to(model.dtype).transpose(1, 2) for _ in range(2))
        want = [t.clone() for t in pools]
        ref.paged_kv_write_ref(*want, k_new, v_new, table, start, lens_t)
        got = [t.clone() for t in pools]
        ops.paged_kv_write(*got, k_new, v_new, table, start, lens_t)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"decode_graph: the paged KV write at {label} differs from "
              f"its plain version")
        n_bytes = 4 * sum(lens) * h * d * pools[0].element_size()
        out[label] = {
            "ms": device_ms(torch, lambda: ops.paged_kv_write(
                *got, k_new, v_new, table, start, lens_t)),
            "plain_ms": device_ms(torch, lambda: ref.paged_kv_write_ref(
                *want, k_new, v_new, table, start, lens_t)),
            "max_abs_err": 0.0, "library_ms": None,
            "lanes_written": sum(lens), **bound_row(n_bytes, 0, 1.0)}
    return out


def decode_graph_phase(torch, dev, model, smi: str) -> dict:
    """The decode graph against the forced-eager path on ``model``
    (module docstring, phase 3b)."""
    import contextlib

    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    cfg = model.cfg
    runs = {}
    for label in ("graph", "eager"):
        engine = InferenceEngine(model, EngineConfig(**ENGINE))
        reqs = graph_requests(cfg.vocab_size)
        ctx = (engine_mod._forced_eager() if label == "eager"
               else contextlib.nullcontext())
        with ctx:
            out = drive(torch, engine, reqs, f"decode_graph {label}")
        runs[label] = {"tokens": [list(r.generated) for r in reqs],
                       "launches": out["launches"],
                       "decode_iters": engine.decode_iters,
                       "decode_graph_iters": engine.decode_graph_iters,
                       "decode_block_hist": engine.decode_block_hist,
                       "decode_s": out["time_by_kind_s"].get("decode", 0.0),
                       "wall_s": out["wall_s"]}
        del engine
        torch.cuda.empty_cache()
    graph, eager = runs["graph"], runs["eager"]
    check(graph["tokens"] == eager["tokens"],
          "decode_graph: the graph path served other tokens than the "
          "eager path")
    check(graph["launches"] == eager["launches"],
          f"decode_graph: launches {graph['launches']} (graph) != "
          f"{eager['launches']} (eager)")
    check(graph["decode_graph_iters"] == graph["decode_iters"]
          >= GRAPH_L_OUT - 1 and eager["decode_graph_iters"] == 0,
          f"decode_graph: {graph['decode_graph_iters']} of "
          f"{graph['decode_iters']} iterations replayed")
    times = {}
    for turn in range(2):        # in turns: eager, graph, eager, graph
        for label in ("eager", "graph"):
            times.setdefault(label, []).append(
                graph_iteration_times(torch, model, label == "eager"))
    per_path = {label: {k: float(np.mean([t[k] for t in ts]))
                        for k in ts[0]} for label, ts in times.items()}
    # the tracer drops a device event now and then (device_ms): the
    # replayed kernels must show, near every layer's
    check(min(p["paged_kernel_ops"] for p in per_path.values())
          >= 0.9 * model.n_attn,
          f"decode_graph: the profiler saw {per_path} paged kernels")
    out = {"phase": "decode_graph", "nvidia_smi": smi, "model": cfg.name,
           "engine": ENGINE, "tokens_identical": True,
           "iterations": graph["decode_iters"],
           **{f"{k}_{label}": runs[label][k] for label in runs
              for k in ("decode_block_hist", "decode_s", "wall_s")},
           "k1_iteration": per_path, "k1_turns": times,
           "paged_kv_write": kv_write_timing(torch, dev, model),
           "launches": graph["launches"]}
    emit(out)
    return out


def c1_pass_times(out: dict) -> dict:
    """Mean time of one C == 1 pass of a serving phase's decode steps:
    the engine's measured time and the CUDA events' (the phase runs no
    speculation, so every decode step is C == 1 passes)."""
    n = max(out["c1_passes"], 1)
    decode_s = out["time_by_kind_s"].get("decode", 0.0)
    return {"c1_pass_ms": 1e3 * decode_s / n,
            "c1_pass_gpu_ms": out["gpu_ms_by_kind"].get("decode", 0.0) / n}


def drive(torch, engine, reqs, phase: str) -> dict:
    """Serve ``reqs`` (all arriving at t=0) to completion with the
    launch counts set to 0 just before; check that every request got
    its ``l_out`` tokens; return the phase's summary."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    log = step_until_idle(torch, engine, phase)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    check_served(reqs, phase)
    return {**serving_summary(engine, reqs, phase, log), "wall_s": wall,
            "launches": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def step_until_idle(torch, engine, phase: str, log=None) -> dict:
    """Step ``engine`` until it holds no work, refitting its profiler
    every 25 steps (Eq. 1/2 online).  ``log`` (created if None, and
    returned) gathers the steps by kind, the engine's measured time by
    kind, the CUDA-event time by kind (``gpu_ms_by_kind``: from before
    the step's first launch to after its last kernel) and every
    speculative verify pass's (width, seconds)."""
    if log is None:
        log = {"steps": 0, "steps_by_kind": {}, "time_by_kind_s": {},
               "gpu_ms_by_kind": {}, "verify": []}
    while engine.queue or engine.prefilling or engine.active:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ev = engine.step()
        end.record()
        end.synchronize()
        log["steps"] += 1
        kind = ev["kind"]
        for key, val in (("steps_by_kind", 1),
                         ("time_by_kind_s", ev.get("time", 0.0)),
                         ("gpu_ms_by_kind", start.elapsed_time(end))):
            log[key][kind] = log[key].get(kind, 0) + val
        if ev.get("spec"):
            log["verify"].append((ev["k"], ev["time"]))
        if log["steps"] % 25 == 0:
            engine.fit_profiler()
        check(log["steps"] < 20_000, f"{phase} phase did not drain")
    return log


def check_served(reqs, phase: str) -> None:
    for r in reqs:
        check(r.finish_time is not None and len(r.generated) == r.l_out,
              f"{phase}: request {r.rid} produced {len(r.generated)} of "
              f"{r.l_out}")


def serving_summary(engine, reqs, phase: str, log: dict) -> dict:
    """The numbers every serving phase prints for ``reqs`` served by
    ``engine`` (TTFT / TPOT percentiles, decode tok/s over the decode
    steps' measured time, the step log)."""
    from repro_torch.serving.metrics import compute_metrics

    cfg = engine.model.cfg
    m = compute_metrics(reqs, cost_units=engine.clock,
                        makespan=engine.clock)
    ttft = np.array([r.ttft for r in reqs])
    tpot = np.array([r.tpot for r in reqs])
    decode_s = log["time_by_kind_s"].get("decode", 0.0)
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
        **{k: v for k, v in log.items() if k != "verify"},
        "engine_clock_s": engine.clock,
        "decode_block_hist": engine.decode_block_hist,
        "c1_passes": c1_passes(engine),
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
# phase 5: the prefix cache
# ---------------------------------------------------------------------------


def prefix_requests(vocab: int) -> list:
    """16 chat requests over 4 Zipfian system prompts of 1024 tokens,
    each with a private suffix of 1-64 tokens and 32 output tokens."""
    from repro_torch.serving.workload import (
        materialize_prompts,
        shared_prefix_workload,
    )

    reqs = shared_prefix_workload(
        n=PREFIX_N, n_groups=PREFIX_GROUPS, shape="chat",
        prefix_len=PREFIX_LEN, suffix_len=PREFIX_SUFFIX, l_out=PREFIX_L_OUT,
        seed=SEED)
    materialize_prompts(reqs, vocab, seed=SEED, max_len=ENGINE["max_len"])
    return reqs


def divergences(torch, model, prompts, got, want) -> list:
    """Where two runs' token lists first differ, and the top-2 logit
    margin of ``want``'s run there (recomputed on the plain route): a
    margin within the dtype's rounding says a near-tie flipped."""
    out = []
    for i, (p, a, b) in enumerate(zip(prompts, got, want)):
        if a != b:
            j = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            out.append({"request": i, "position": j, "margin": top2_margin(
                torch, model, list(p) + b[:j])})
    return out


def waves(reqs) -> tuple[list, list]:
    """The first request of each prefix group, and all the others."""
    first: dict = {}
    for r in reqs:
        first.setdefault(r.prefix_group, r.rid)
    one = set(first.values())
    return ([r for r in reqs if r.rid in one],
            [r for r in reqs if r.rid not in one])


def serve_waves(torch, engine, reqs, phase: str) -> dict:
    """Serve the first wave to completion, then the second, each
    request arriving when its wave starts; the second wave's TTFT."""
    log = None
    for wave in waves(reqs):
        for r in wave:
            r.arrival = None        # the engine stamps its clock
            engine.submit(r)
        log = step_until_idle(torch, engine, phase, log)
    check_served(reqs, phase)
    ttft = np.array([r.ttft for r in waves(reqs)[1]])
    return {"log": log,
            "wave2_ttft_p50_s": float(np.percentile(ttft, 50)),
            "wave2_ttft_p99_s": float(np.percentile(ttft, 99))}


def prefix_phase(torch, dev, model) -> dict:
    """Shared-prefix chat traffic served in two waves (the first request
    of each group, then the other 12 at once), with the prefix cache on
    and off; then one request that hit handed from a parking engine to a
    second engine.  Every request must be served; the cache must hit;
    the prefill tokens saved must equal the hit tokens exactly; the
    paged decode kernel must have run 32 times per C == 1 pass over the
    phase's engines and the page gather twice (the one hand-off); after
    the hand-off's evict no cached page may be referenced."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    cfg = model.cfg
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    runs, passes, tokens = {}, 0, {}
    for on in (True, False):
        reqs = prefix_requests(cfg.vocab_size)
        prompts = [r.prompt for r in reqs]
        engine = InferenceEngine(model, EngineConfig(**ENGINE,
                                                     prefix_cache=on))
        run = serve_waves(torch, engine, reqs, "prefix")
        log = run["log"]
        runs[on] = {
            "n_prefill_tokens": engine.n_prefill_tokens,
            "prefill_step_s": log["time_by_kind_s"].get("prefill_chunk", 0),
            "prefill_gpu_ms": log["gpu_ms_by_kind"].get("prefill_chunk", 0),
            "prefill_steps": log["steps_by_kind"].get("prefill_chunk", 0),
            "wave2_ttft_p50_s": run["wave2_ttft_p50_s"],
            "wave2_ttft_p99_s": run["wave2_ttft_p99_s"],
            "c1_passes": c1_passes(engine),
            "decode_block_hist": engine.decode_block_hist,
            "prefix_stats": engine.prefix.stats() if on else None,
            "hit_tokens": sum(r.prefix_hit_tokens for r in reqs),
        }
        passes += c1_passes(engine)
        tokens[on] = [list(r.generated) for r in reqs]
        del engine, run
        torch.cuda.empty_cache()
    hits = runs[True]["prefix_stats"]["n_hit_tokens"]
    check(hits > 0, "the prefix cache never hit")
    check(runs[True]["hit_tokens"] == hits,
          "requests' hit tokens do not add up to the cache's")
    saved = runs[False]["n_prefill_tokens"] - runs[True]["n_prefill_tokens"]
    check(saved == hits, f"prefill tokens saved {saved} != hit tokens {hits}")
    diverged = divergences(torch, model, prompts, tokens[True], tokens[False])

    handoff, hand_passes = prefix_handoff(torch, model)
    passes += hand_passes
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check(launches["paged_decode_attention"] == cfg.n_layers * passes,
          f"prefix: decode-attention launches "
          f"{launches['paged_decode_attention']} != {cfg.n_layers} x "
          f"{passes} C==1 passes")
    check(launches["page_gather"] == 2,
          f"prefix: page-gather launches {launches['page_gather']} != 2")
    out = {"phase": "prefix", "model": cfg.name, "engine": ENGINE,
           "traffic": {"n": PREFIX_N, "groups": PREFIX_GROUPS,
                       "prefix_len": PREFIX_LEN, "suffix_len": PREFIX_SUFFIX,
                       "l_out": PREFIX_L_OUT},
           "on": runs[True], "off": runs[False],
           "prefill_tokens_saved": saved,
           "token_match_share": 1 - len(diverged) / len(tokens[True]),
           "first_divergence": diverged,
           "handoff": handoff, "c1_passes": passes, "launches": launches,
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def prefix_handoff(torch, model) -> tuple[dict, int]:
    """A group-mate of a served request, admitted over its published
    pages on a parking engine, exported, evicted and imported into a
    second engine: tokens equal to the same two requests served
    colocated.  Returns the summary and the C == 1 passes run."""
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    first, rest = waves(prefix_requests(model.cfg.vocab_size))
    warm = first[0]
    mate = next(r for r in rest if r.prefix_group == warm.prefix_group)

    def two(engine, park: bool):
        w, r = (dataclasses.replace(x, generated=None, arrival=None)
                for x in (warm, mate))
        engine.submit(w)
        engine.run_until_done()
        engine.park_on_prefill = park
        engine.submit(r)
        engine.run_until_done()
        check(r.prefix_hit_tokens > 0, "the hand-off request did not hit")
        return r

    colocated = InferenceEngine(model, EngineConfig(**ENGINE,
                                                    prefix_cache=True))
    want = list(two(colocated, False).generated)
    passes = c1_passes(colocated)
    del colocated
    torch.cuda.empty_cache()
    a = InferenceEngine(model, EngineConfig(**ENGINE, prefix_cache=True))
    r = two(a, True)
    check(r.slot in a.parked, "the hit request did not park")
    pages = a.kv.pages_of(r.slot)
    shared = [p for p in pages if a.prefix.is_cached(p)]
    check(shared and pages[:len(shared)] == shared,
          "the parked table does not start with shared pages")
    payload = a.export_kv(r.rid)
    a.evict(r.slot)
    refs = [a.prefix.refs(p) for p in list(a.prefix._entries)]
    check(not any(refs), f"cached pages still referenced after evict: {refs}")
    check(a.kv.n_available_pages == a.kv.n_pages,
          "pages leaked after the hand-off's evict")
    passes += c1_passes(a)
    del a
    torch.cuda.empty_cache()
    b = InferenceEngine(model, EngineConfig(**ENGINE))
    check(b.import_kv(payload, r), "import_kv refused the payload")
    b.run_until_done()
    passes += c1_passes(b)
    check(r.generated == want,
          "hand-off tokens differ from the colocated run's")
    out = {"hit_tokens": r.prefix_hit_tokens, "shared_pages": len(shared),
           "pages": len(pages), "payload_bytes": payload.nbytes,
           "tokens_identical": True}
    del b, payload
    torch.cuda.empty_cache()
    return out, passes


# ---------------------------------------------------------------------------
# phase 6: SLO-customized speculative decoding
# ---------------------------------------------------------------------------


def spec_requests(vocab: int) -> list:
    """The first 8 Table-1 requests (random prompts) and 8 repetitive
    ones: a random 24-token phrase tiled to 768 tokens, 128 output
    tokens, with the Table-1 SLOs of their task."""
    from repro_torch.core.request import FOUR_TASK_SET, TASKS, Request

    reqs = table1_requests(vocab)[:SPEC_N_TABLE1]
    rng = np.random.default_rng(SEED + 12)
    for i in range(SPEC_N_REPEAT):
        spec = TASKS[FOUR_TASK_SET[i % len(FOUR_TASK_SET)]]
        phrase = rng.integers(0, vocab, SPEC_PHRASE).astype(np.int32)
        prompt = np.tile(phrase, SPEC_L_IN // SPEC_PHRASE)
        reqs.append(Request.from_prompt(
            len(reqs), prompt, SPEC_L_OUT, task=spec.name,
            ttft_slo=spec.ttft_slo, tpot_slo=spec.tpot_slo))
    return reqs


def spec_phase(torch, dev, model) -> dict:
    """The 16 requests with speculation on (``max_spec_len`` 8) and off.
    Every request must be served; speculation must have dispatched, at
    most every proposed token accepted, the depth histogram summing to
    the dispatches; the paged decode kernel must have run 32 times per
    C == 1 pass (verify passes are C >= 2 and launch none)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    cfg = model.cfg
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    runs, passes, tokens = {}, 0, {}
    for on in (True, False):
        reqs = spec_requests(cfg.vocab_size)
        prompts = [r.prompt for r in reqs]
        engine = InferenceEngine(model, EngineConfig(
            **ENGINE, spec_decode=on, max_spec_len=SPEC_MAX_LEN))
        for r in reqs:
            engine.submit(r)
        log = step_until_idle(torch, engine, "spec")
        check_served(reqs, "spec")
        summary = serving_summary(engine, reqs, "spec", log)
        c1 = c1_passes(engine)
        plain_s = (log["time_by_kind_s"].get("decode", 0.0)
                   - sum(t for _, t in log["verify"]))
        by_width: dict = {}
        for width, t in log["verify"]:
            by_width.setdefault(str(width), []).append(1e3 * t)
        runs[on] = {
            **{k: summary[k] for k in ("tpot_p50_s", "tpot_p99_s",
                                       "ttft_p50_s", "ttft_p99_s",
                                       "decode_tok_per_s", "steps_by_kind",
                                       "decode_block_hist")},
            "c1_passes": c1, "c1_pass_ms": 1e3 * plain_s / max(c1, 1),
            # keyed by the pass's chunk length C = padded width + 1
            "verify_pass_ms_by_c": {
                w: {"n": len(v), "mean": float(np.mean(v))}
                for w, v in sorted(by_width.items(), key=lambda x: int(x[0]))},
            "spec_dispatches": engine.n_spec_dispatches,
            "spec_proposed": engine.n_spec_proposed,
            "spec_accepted": engine.n_spec_accepted,
            "spec_depth_hist": engine.spec_depth_hist,
            "spec_task_stats": engine.spec_task_stats,
        }
        passes += c1
        tokens[on] = [list(r.generated) for r in reqs]
        del engine
        torch.cuda.empty_cache()
    on = runs[True]
    check(on["spec_dispatches"] > 0, "speculation never dispatched")
    check(on["spec_accepted"] <= on["spec_proposed"],
          "more tokens accepted than proposed")
    check(sum(on["spec_depth_hist"].values()) == on["spec_dispatches"],
          "the depth histogram does not sum to the dispatches")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check(launches["paged_decode_attention"] == cfg.n_layers * passes,
          f"spec: decode-attention launches "
          f"{launches['paged_decode_attention']} != {cfg.n_layers} x "
          f"{passes} C==1 passes")
    check(launches["page_gather"] == 0, "the spec phase exported KV")
    diverged = divergences(torch, model, prompts, tokens[True], tokens[False])
    out = {"phase": "spec", "model": cfg.name, "engine": ENGINE,
           "max_spec_len": SPEC_MAX_LEN,
           "traffic": {"table1": SPEC_N_TABLE1, "repetitive": SPEC_N_REPEAT,
                       "phrase": SPEC_PHRASE, "l_in": SPEC_L_IN,
                       "l_out": SPEC_L_OUT},
           "on": on, "off": runs[False],
           "acceptance_share": (on["spec_accepted"]
                                / max(on["spec_proposed"], 1)),
           "token_match_share": 1 - len(diverged) / len(tokens[True]),
           "first_divergence": diverged,
           "c1_passes": passes, "launches": launches,
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phases 7 and 8: the port's Cluster on qwen7b, colocated and P/D
# ---------------------------------------------------------------------------


def alone_tokens(model, prompt, l_out: int) -> list:
    """Greedy tokens of ``prompt`` served alone by a small engine of its
    own over ``model`` (a detached profiler: nothing feeds the cluster's
    fit)."""
    from repro_torch.core.latency_model import FittedLatencyModel
    from repro_torch.core.request import Request
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    engine = InferenceEngine(model, EngineConfig(**ALONE_ENGINE),
                             profiler=FittedLatencyModel())
    r = Request.from_prompt(0, prompt, l_out)
    engine.submit(r)
    engine.run_until_done()
    check(len(r.generated) == l_out, "a lone request fell short")
    return list(r.generated)


def storages(model) -> set:
    return {p.untyped_storage().data_ptr() for p in model.parameters()}


def time_transports(torch, cluster) -> dict:
    """Provision the whole tree once per Table-2 transport (d2d from
    replica 0 — twice —, cpu from the host offload, disk from the
    checkpoint), each copy checked bit for bit against replica 0's and
    released after it is timed; the d2d copy must also decode a prompt
    alone to the donor's tokens.  The probes go through a shallow copy of
    the cluster's WeightManager (the same host copy and checkpoint) that
    reports to no TLManager and owns only replica 0's weights: the timed
    run's Scaler then starts from what a deployment knows, the H100
    guesses and the initial replicas' provisions, not from these probes."""
    import copy

    from repro_torch.serving.cluster import replica_model

    donor = cluster.workers[0].engine.model
    ref = cluster.weights.params_of(0)
    wm = copy.copy(cluster.weights)
    wm.tl, wm._owned = None, {}
    wm.adopt(0, ref)
    prompt = np.random.default_rng(SEED + 2).integers(
        0, donor.cfg.vocab_size, size=TRANSPORT_L_IN).astype(np.int32)
    out = {"gb": wm.nbytes / 1e9}
    for i, strategy in enumerate(("d2d", "cpu", "disk")):
        params, secs = wm.provision(1000 + i, strategy,
                                    donor=0 if strategy == "d2d" else None)
        check(all(torch.equal(params[k], t) for k, t in ref.items()),
              f"the {strategy} copy differs from replica 0's weights")
        row = {"s": secs, "gb_per_s": wm.nbytes / secs / 1e9}
        if strategy == "d2d":
            # again, into the blocks the first copy held: the caching
            # allocator then asks CUDA for no new memory, so the
            # difference is what allocating the replica's memory cost
            wm.release(1000 + i)
            del params
            params, row["s_reused_blocks"] = wm.provision(1000 + i, "d2d",
                                                          donor=0)
            copy = replica_model(cluster.cfg.model, params)
            check(not storages(copy) & storages(donor),
                  "the d2d copy aliases its donor")
            got = alone_tokens(copy, prompt, TRANSPORT_L_OUT)
            want = alone_tokens(donor, prompt, TRANSPORT_L_OUT)
            check(got == want, "the d2d replica's tokens differ from its "
                               "donor's")
            row["tokens_equal_donor"] = True
            del copy
        out[strategy] = row
        wm.release(1000 + i)
        del params
        torch.cuda.empty_cache()
    return out


def cluster_phase(torch, dev, phase: str) -> dict:
    """``Cluster(backend="engine")`` serving 24 Table-1 requests with
    Poisson arrivals on full-width qwen7b in bf16: colocated on 2
    replicas with the Scaler on (``cluster``; the transports are timed
    first), or prefill on one replica and decode on another
    (``cluster_pd``).  Every request must finish with its ``l_out``
    tokens; the paged decode kernel must have run 32 times per C == 1
    pass summed over the replicas, and the page gather twice per P/D
    hand-off (K and V pools) and never when colocated; the replicas'
    weights must share no storage."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.core.latency_model import H100
    from repro_torch.core.request import FOUR_TASK_SET
    from repro_torch.core.scaler import ScalerConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.cluster import Cluster, ClusterConfig
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.workload import poisson_workload

    pd = phase == "cluster_pd"
    layout = (dict(mode="pd", n_prefill=1, n_decode=1) if pd else
              dict(n_workers=2, scaling=True,
                   # a floor of 2: the Scaler may add a third replica
                   # and take it back, but the phase always ends with
                   # two live replicas whose storages it can compare
                   scaler=ScalerConfig(max_workers=3, min_workers=2,
                                       weight_strategy="d2d")))
    cfg = ClusterConfig(model=get_config("qwen7b"), backend="engine",
                        policy="hyperflexis",
                        engine=EngineConfig(**CLUSTER_ENGINE), hw=H100,
                        seed=SEED, **layout)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cluster = Cluster(cfg, device=dev, dtype=torch.bfloat16,
                      ckpt_dir=str(ROOT / "build" / "weights"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    loads = cluster.tl.n_weight_loads
    transports = None if pd else time_transports(torch, cluster)
    check(cluster.tl.n_weight_loads == loads,
          "the transport probes reported to the cluster's TLManager")

    reqs = poisson_workload(FOUR_TASK_SET, qps=CLUSTER_QPS,
                            n_per_task=CLUSTER_N_PER_TASK, seed=SEED)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = cluster.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()

    for r in reqs:
        check(r.finish_time is not None and len(r.generated) == r.l_out,
              f"{phase}: request {r.rid} produced {len(r.generated)} of "
              f"{r.l_out}")
    passes = {w.wid: c1_passes(w.engine) for w in cluster.workers}
    n_layers = cfg.model.n_layers
    n_passes = sum(passes.values())
    check(launches["paged_decode_attention"] == n_layers * n_passes,
          f"{phase}: decode-attention launches "
          f"{launches['paged_decode_attention']} != {n_layers} x "
          f"{n_passes} C==1 passes")
    if pd:
        check(res.kv_transfers > 0, "cluster_pd handed off nothing")
        check(launches["page_gather"] == 2 * res.kv_transfers,
              f"page-gather launches {launches['page_gather']} != 2 x "
              f"{res.kv_transfers} hand-offs")
        prefill = [w.wid for w in cluster.workers if w.role == "prefill"]
        check(prefill and all(passes[wid] == 0 for wid in prefill),
              "a prefill worker ran a C == 1 pass")
    else:
        check(launches["page_gather"] == 0, "the cluster phase exported KV")
    scaled_in = {wid for _, wid, ev in res.timeline if ev == "scale_in"}
    for wid in scaled_in:
        w = next(w for w in cluster.workers if w.wid == wid)
        check(w.engine.model is None and not cluster.weights.owns(wid),
              f"{phase}: replica {wid} scaled in but still holds weights")
    live = [w.engine.model for w in cluster.workers
            if w.engine.model is not None]
    seen: set = set()
    for ptrs in map(storages, live):
        check(not ptrs & seen, f"{phase}: two replicas share weights")
        seen |= ptrs
    check(len(live) >= 2,
          f"{phase}: {len(live)} replica(s) hold weights, fewer than 2 "
          f"(scale-outs {res.n_scale_out}, scale-ins {res.n_scale_in})")
    placed = replicas_placed(cluster, phase)
    check(set(placed.values()) == {str(dev)},
          f"{phase}: replicas placed on {placed}, not {dev} alone")

    m = res.metrics
    ttft = np.array([r.ttft for r in reqs])
    tpot = np.array([r.tpot for r in reqs if r.tpot is not None])
    dispatches = {(r.prefill_worker, r.dispatch_time) for r in reqs}
    peak = torch.cuda.max_memory_allocated()
    check(peak < PEAK_LIMIT_BYTES,
          f"{phase}: peak memory {peak / 1e9:.1f} GB over the limit")
    out = {
        "phase": phase, "model": cfg.model.name,
        "n_layers": n_layers, "d_model": cfg.model.d_model,
        "dtype": "bfloat16", "params": cfg.model.param_count(),
        "layout": {k: v for k, v in layout.items() if k != "scaler"},
        "policy": cfg.policy, "engine": CLUSTER_ENGINE,
        "traffic": {"tasks": list(FOUR_TASK_SET), "qps": CLUSTER_QPS,
                    "n": len(reqs)},
        "served": m.n_finished, "n_total": m.n_total,
        "prompt_tokens": int(sum(r.l_in for r in reqs)),
        "output_tokens": int(sum(r.l_out for r in reqs)),
        "attainment": m.attainment, "ttft_attainment": m.ttft_attainment,
        "tpot_attainment": m.tpot_attainment,
        "per_task": {t: {k: v[k] for k in ("attainment", "ttft_attainment",
                                           "tpot_attainment", "n")}
                     for t, v in m.per_task.items()},
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_p99_s": float(np.percentile(ttft, 99)),
        "tpot_p50_s": float(np.percentile(tpot, 50)),
        "tpot_p99_s": float(np.percentile(tpot, 99)),
        # the cluster's clock is virtual: each replica's measured steps
        # overlap as if every replica had a card of its own, while on
        # this one card they ran in turn; the ratio says by how much
        # the clock (and with it TTFT, TPOT and attainment) runs ahead
        # of what one card served
        "clock": "virtual, a card per replica",
        "makespan_s": m.makespan, "wall_s": wall,
        "makespan_over_wall": m.makespan / wall, "init_s": init_s,
        "n_weight_loads": cluster.tl.n_weight_loads,
        "n_scale_out": res.n_scale_out, "n_scale_in": res.n_scale_in,
        "n_role_flips": res.n_role_flips, "kv_transfers": res.kv_transfers,
        "dispatches": len(dispatches),
        "dispatched_by_worker": {
            str(w.wid): sum(r.prefill_worker == w.wid for r in reqs)
            for w in cluster.workers},
        "c1_passes_by_worker": {str(k): v for k, v in passes.items()},
        "decode_block_hist": res.decode_block_hist,
        "n_dispatches": res.n_dispatches,
        "timeline": [(round(t, 4), wid, ev) for t, wid, ev in res.timeline],
        "transports": transports, "launches": launches,
        "peak_mem_gb": peak / 1e9, "placement": placed,
    }
    emit(out)
    del cluster, res, live
    gc.collect()
    torch.cuda.empty_cache()
    return out


def replicas_placed(cluster, phase: str) -> dict:
    """Each live replica's ``WeightManager.placement``, after checking
    that its weights, its engine and its KV pool lie there."""
    placed = {}
    for w in cluster.workers:
        if w.engine.model is None:
            continue
        where = cluster.weights.placement(w.wid)
        tensors = [*w.engine.model.parameters(),
                   *(t for seg in w.engine.caches for t in seg.values())]
        check(w.engine.device == where
              and all(t.device == where for t in tensors),
              f"{phase}: replica {w.wid}'s weights or KV pool left {where}")
        placed[str(w.wid)] = str(where)
    return placed


# ---------------------------------------------------------------------------
# phase 8b: replicas on the card and the host
# ---------------------------------------------------------------------------


def placement_requests(vocab: int, l_out=None) -> list:
    from repro_torch.core.request import Request

    rng = np.random.default_rng(SEED + 12)
    reqs, t = [], 0.0
    for i in range(PLACEMENT_N):
        t += float(rng.exponential(0.05))
        l_in = int(rng.integers(4, 14))
        reqs.append(Request(
            rid=i, task="chat" if i % 2 else "doc", arrival=t, l_in=l_in,
            l_out=l_out or int(rng.integers(2, 6)), ttft_slo=5.0,
            tpot_slo=2.0,
            prompt=rng.integers(0, vocab, size=l_in).astype(np.int32)))
    return reqs


def placement_cluster(torch, layout: str, devices, seed_params):
    """A smoke-width qwen7b ``Cluster`` in f32 over ``devices`` for
    ``layout`` (``pd``, one prefill and one decode replica;
    ``live_migration``, two colocated replicas), on ``seed_params``: a
    seed's draw differs between the card's generator and the host's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving.cluster import Cluster, ClusterConfig
    from repro_torch.serving.engine import EngineConfig

    pd = layout == "pd"
    kw = (dict(mode="pd", n_prefill=1, n_decode=1, policy="hyperflexis")
          if pd else dict(n_workers=2, policy="rr", live_migration=True))
    engine = dict(PLACEMENT_ENGINE, **({} if pd else {"decode_block": 2}))
    cfg = ClusterConfig(model=get_smoke_config("qwen7b"), backend="engine",
                        engine=EngineConfig(**engine), seed=SEED, **kw)
    return Cluster(cfg, devices=devices, seed_params=seed_params,
                   dtype=torch.float32)


def placement_serve(torch, cluster, layout: str) -> tuple:
    """Serve ``PLACEMENT_N`` requests on ``cluster``; on the
    ``live_migration`` layout, replica 0's residents migrate live to
    replica 1 once one of them has ``PLACEMENT_KICK_TOKENS`` tokens.
    Returns (result, requests, wall s)."""
    from repro_torch.core.request import RequestState
    from repro_torch.core.scaler import ScaleAction
    from repro_torch.serving.session import ServingSession

    pd = layout == "pd"
    reqs = placement_requests(cluster.cfg.model.vocab_size,
                              None if pd else PLACEMENT_MIGRATE_L_OUT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if pd:
        res = cluster.run(reqs)
    else:
        session = ServingSession(cluster, admission="none")
        for r in reqs:
            session.submit_request(r)
        kicked = False
        while cluster.process_next() is not None:
            w0 = cluster._by_wid[0]
            if not kicked and any(r.tokens_done >= PLACEMENT_KICK_TOKENS
                                  for r in w0.running):
                cluster._begin_evacuation(
                    w0, ScaleAction("in", "collocated", 0.0, worker_id=0),
                    cluster.now)
                kicked = True
            if (all(r.state == RequestState.FINISHED for r in reqs)
                    and not cluster._evac):
                break
        check(kicked, "placement: replica 0 never held a decoding request")
        res = session.close(requests=list(reqs))
    torch.cuda.synchronize()
    return res, reqs, time.perf_counter() - t0


def placement_phase(torch) -> dict:
    """Replicas on ``[cuda:0, cpu]`` against the same clusters on
    ``[cpu]`` (module docstring, phase 8b)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models.build import seeded_model
    from repro_torch.serving import engine as engine_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    seed = seeded_model(get_smoke_config("qwen7b"), cpu, SEED)
    out = {"phase": "placement", "cards": torch.cuda.device_count(),
           "devices": [str(card), str(cpu)], "dtype": "float32"}
    total, clusters = Counter(), {}
    for layout in ("pd", "live_migration"):
        ref_cluster = placement_cluster(torch, layout, [cpu],
                                        seed.state_dict())
        _, want, _ = placement_serve(torch, ref_cluster, layout)
        # built (and warmed up on both devices) before the counts are
        # set to 0: the run's launches are its replicas' alone
        cluster = placement_cluster(torch, layout, [card, cpu],
                                    seed.state_dict())
        ops.reset_launch_counts()
        with KeptKernelCalls(torch, ops) as kept, engine_mod._forced_eager():
            res, reqs, wall = placement_serve(torch, cluster, layout)
        launches = ops.launch_counts()
        total.update(launches)
        clusters[layout] = cluster
        check(all(r.finish_time is not None
                  and len(r.generated) == r.l_out for r in reqs),
              f"placement {layout}: a request fell short")
        got = [list(r.generated) for r in reqs]
        ref_tokens = [list(r.generated) for r in want]
        if got != ref_tokens:
            gaps = divergences(torch, seed, [r.prompt for r in want], got,
                               ref_tokens)
            emit({"phase": "placement", "layout": layout,
                  "divergences": gaps})
        check(got == ref_tokens,
              f"placement {layout}: tokens differ from the [cpu] run's")
        # replica 0 of the live-migration layout is scaled in: only a
        # live replica's tensors can be checked, every one's placement
        placed = replicas_placed(cluster, f"placement {layout}")
        replicas = {str(w.wid): str(cluster.weights.placement(w.wid))
                    for w in cluster.workers}
        check(replicas == {"0": str(card), "1": str(cpu)}
              and placed.items() <= replicas.items(),
              f"placement {layout}: replicas placed on {replicas}")
        on_card = next(w.engine for w in cluster.workers if w.wid == 0)
        handoffs = (res.kv_transfers if layout == "pd"
                    else res.n_live_migrations)
        check(handoffs > 0, f"placement {layout}: nothing handed off")
        kv_bytes = (cluster.tl.kv_bytes_moved, ref_cluster.tl.kv_bytes_moved)
        # a P/D hand-off moves the prompt's KV: the same bytes wherever
        # the replicas lie (a live migration's depend on when it lands)
        check(layout != "pd" or kv_bytes[0] == kv_bytes[1],
              f"placement pd: {kv_bytes[0]} bytes handed off, the [cpu] "
              f"run {kv_bytes[1]}")
        want_launches = {
            "page_gather": 2 * handoffs,
            "paged_decode_attention": (cluster.cfg.model.n_layers
                                       * c1_passes(on_card)),
            "paged_kv_write": (cluster.cfg.model.n_layers
                               * paged_passes(on_card))}
        check({k: n for k, n in launches.items() if n}
              == {k: n for k, n in want_launches.items() if n},
              f"placement {layout}: launches {launches}, not "
              f"{want_launches} (the card replica's alone)")
        held = kept.hold(f"placement {layout}")
        unheld = {k: n for k, n in launches.items()
                  if held.get(k, {}).get("calls", 0) < n}
        check(not unheld, f"placement {layout}: launches {unheld} but "
                          f"calls kept {held}")
        out[layout] = {
            "served": res.metrics.n_finished, "n_total": len(reqs),
            "tokens_equal_cpu_run": True, "replicas": replicas,
            "handoffs": handoffs, "kv_bytes": kv_bytes[0],
            "kv_bytes_cpu_run": kv_bytes[1],
            "c1_passes_on_card": c1_passes(on_card), "launches": launches,
            "held": held, "wall_s": wall}
    # d2d from the P/D cluster's card replica to a replica placed on the
    # host
    wm = clusters["pd"].weights
    wid = next(w for w in range(1000, 1002) if wm.placement(w) == cpu)
    donor = wm.params_of(0)
    params, secs = wm.provision(wid, "d2d", donor=0)
    check(all(t.device == cpu for t in params.values())
          and all(torch.equal(params[k], t.cpu()) for k, t in donor.items()),
          "placement: the card-to-host d2d copy differs from its donor")
    wm.release(wid)
    out["d2d_card_to_host"] = {
        "s": secs, "gb": wm.nbytes / 1e9, "gb_per_s": wm.nbytes / secs / 1e9,
        "bitwise_equal": True,
        "link": "host link (PCIe), card to host memory; not NVLink"}
    out["launches"] = {k: total.get(k, 0) for k in ops.launch_counts()}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 9: slot plane, gemma3-4b
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
# phases 10-11: mamba2 on the slot plane, zamba2 on the paged plane
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
    writes = model.n_attn * paged_passes(engine)
    check(launches["paged_kv_write"] == writes,
          f"hybrid: paged KV writes {launches['paged_kv_write']} != {writes}")
    # chunked prefill carries the SSM state, so the SSD takes the plain
    # scan there, as in the JAX package
    others = {k: n for k, n in launches.items()
              if k not in PAGED_KERNELS and n}
    check(not others, f"the hybrid phase ran other kernels: {others}")
    out.update(engine=ENGINE, init_s=init_s, attn_layers=model.n_attn,
               mamba_layers=model.n_mamba)
    emit(out)
    del engine
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 14: olmoe-1b-7b (MoE) on the paged plane
# ---------------------------------------------------------------------------


def moe_phase(torch, dev, model, init_s: float):
    """``serve``'s 16 requests on olmoe: every request served, the paged
    decode kernel 16 times per C == 1 pass and no other kernel (MoE
    experts are plain batched GEMMs, as in the JAX package).  Records
    every MoE call's dropped assignments (capacity counts every row of
    the call: idle slots and padding lanes route too) and times one
    decode pass's MoE FFN against its bound."""
    from repro_torch.models import moe
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    cfg = model.cfg
    engine = InferenceEngine(model, EngineConfig(**ENGINE))
    check(engine.paged, "moe: the engine did not take the paged plane")
    drops = []             # (dropped, assignments) of each MoE call
    ffn = moe.moe_ffn

    def recording_ffn(params, x, c):
        y, aux = ffn(params, x, c)
        n = x.shape[0] * x.shape[1] * c.moe.top_k
        drops.append((aux["drop_frac"] * n, n))
        return y, aux

    moe.moe_ffn = recording_ffn
    try:
        out = drive(torch, engine, table1_requests(cfg.vocab_size), "moe")
    finally:
        moe.moe_ffn = ffn
    launches, passes = out["launches"], out["c1_passes"]
    check(launches["paged_decode_attention"] == model.n_attn * passes,
          f"moe: decode-attention launches "
          f"{launches['paged_decode_attention']} != {model.n_attn} x "
          f"{passes} C==1 passes")
    writes = model.n_attn * paged_passes(engine)
    check(launches["paged_kv_write"] == writes,
          f"moe: paged KV writes {launches['paged_kv_write']} != {writes}")
    others = {k: n for k, n in launches.items()
              if k not in PAGED_KERNELS and n}
    check(not others, f"the moe phase ran other kernels: {others}")
    dropped = float(torch.stack([d for d, _ in drops]).sum())
    out.update(engine=ENGINE, init_s=init_s, **c1_pass_times(out),
               experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
               capacity_factor=cfg.moe.capacity_factor,
               active_params=cfg.active_param_count(),
               moe_calls=len(drops),
               drop_frac=dropped / sum(n for _, n in drops),
               decode_moe_ffn=moe_ffn_timing(torch, dev, model))
    emit(out)
    del engine
    torch.cuda.empty_cache()
    return out


def moe_ffn_timing(torch, dev, model) -> dict:
    """Device time of one decode pass's MoE FFN — every layer's
    ``moe_ffn`` on (n_slots, 1, d) hidden states — against its bound.
    The capacity buffer runs every expert on every call (capacity 8
    rows each at 8 slots), so the pass reads every expert weight once:
    bytes = the MoE weights and the hidden states in and out; operations
    = the router and the buffer's E x C rows through the SwiGLU."""
    from repro_torch.models import moe

    cfg = model.cfg
    m, d = cfg.moe, cfg.d_model
    b = ENGINE["n_slots"]
    h = torch.randn(b, 1, d, generator=torch.Generator(device=dev)
                    .manual_seed(SEED + 12), device=dev).to(model.dtype)
    params = [blk.moe for kind, blk, _, _ in model.blocks() if kind == "moe"]

    def run():
        for p in params:
            moe.moe_ffn(p, h, cfg)

    cap = moe.capacity(cfg, b)
    item = h.element_size()
    n_bytes = sum(sum(t.numel() for t in p.values()) * item + 2 * h.numel()
                  * item for p in params)
    flops = len(params) * (2 * b * d * m.num_experts
                           + m.num_experts * cap * 6 * d * m.expert_d_ff)
    return {"layers": len(params), "rows": b, "capacity": cap,
            "ms": device_ms(torch, run), "event_ms": cuda_ms(torch, run, 10),
            **bound_row(n_bytes, flops, BF16_FLOPS_PER_S)}


# ---------------------------------------------------------------------------
# phases 15-16: hubert-xlarge inferred and trained
# ---------------------------------------------------------------------------


def hubert_phase(torch, dev) -> dict:
    """Full-width hubert-xlarge in bf16 (weights drawn on the card from
    the seed): one ``Model.forward`` over 8 x 1024 random frames with the
    launch counts set to 0 just before — the flash kernel (bidirectional,
    D 80) exactly once per layer, nothing else, finite logits of the
    expected shape — then its wall and device time, flash's device time
    and share of it, and the peak memory;
    then ``parity``: a 2-layer full-width cut in f32 (TF32 off), the
    kernel route's logits against the plain route's within 2e-4."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.build import Model

    cfg = get_config("hubert-xlarge")
    b, s = HUBERT_FRAMES
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, dtype=torch.bfloat16, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    batch = {"frames": torch.randn(b, s, cfg.d_model, generator=g,
                                   device=dev).to(torch.bfloat16)}

    def forward():
        with torch.no_grad():
            return model.forward(batch)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = forward()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(launches["flash_attention"] == cfg.n_layers,
          f"hubert: {launches['flash_attention']} flash launches in one "
          f"forward, not {cfg.n_layers}")
    others = {k: n for k, n in launches.items()
              if k != "flash_attention" and n}
    check(not others, f"the hubert phase ran other kernels: {others}")
    check(tuple(logits.shape) == (b, s, cfg.vocab_size),
          f"hubert: logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "hubert: non-finite logits")
    n = 3
    t0 = time.perf_counter()
    for _ in range(n):
        forward()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    device, flash = device_ms(torch, forward, 2, only="flash")
    out = {"phase": "hubert", "model": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "head_dim": cfg.resolved_head_dim,
           "dtype": "bfloat16", "params": cfg.param_count(),
           "frames": [b, s], "init_s": init_s, "first_forward_s": first_s,
           "forward_wall_ms": wall_ms,
           "forward_device_ms": device, "flash_device_ms": flash,
           "flash_share": flash / device,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches,
           "logit_absmax": float(logits.float().abs().max())}
    del model, logits, batch
    torch.cuda.empty_cache()
    out["parity"] = hubert_parity(torch, dev, cfg)
    emit(out)
    return out


def hubert_parity(torch, dev, cfg) -> dict:
    """hubert cut to 2 layers at full width, f32 with TF32 off: forward
    logits through the flash kernel (its CUDA-core instance at D 80)
    against the plain chunked attention on the same weights and frames,
    within 2e-4."""
    from repro_torch.models.build import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = dataclasses.replace(cfg, n_layers=2)
    model = Model(small, dtype=torch.float32, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(SEED + 15))
    b, s = HUBERT_FRAMES
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    batch = {"frames": torch.randn(b, s, cfg.d_model, generator=g,
                                   device=dev)}
    with torch.no_grad():
        kernel = model.forward(batch)
        model.use_kernels = False
        plain = model.forward(batch)
    torch.cuda.synchronize()
    err = float((kernel - plain).abs().max())
    check(err <= 2e-4, f"hubert: kernel vs plain logits differ by {err}")
    out = {"n_layers": 2, "dtype": "float32", "frames": [b, s],
           "max_abs_logit_err": err, "tol": 2e-4,
           "logit_absmax": float(plain.abs().max())}
    del model, kernel, plain
    torch.cuda.empty_cache()
    return out


def train_phase(torch, dev) -> dict:
    """``TrainRunner`` on full-width hubert-xlarge in f32 (TF32 off,
    stated), ``remat=True`` and the plain attention — JAX's training
    route: no kernel has a backward —, batch 8 x 512 frames over 2
    micro-batches, ``TRAIN_STEPS`` steps with the launch counts set to 0
    just before: every loss and gradient norm finite, no step skipped
    after the first, no kernel launched; prints s/step, tokens/s, peak
    memory and model TFLOP/s (6 x params x tokens / step time) beside
    the f32 peak.  Then crash and resume (``crash_resume``) on hubert cut
    to 4 layers at full width and on the smoke qwen2.5-14b."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.distributed.fault_tolerance import (
        RunnerConfig,
        TrainRunner,
    )
    from repro_torch.kernels import ops
    from repro_torch.models.build import Model
    from repro_torch.training.data import DataConfig
    from repro_torch.training.train_loop import TrainConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("hubert-xlarge")
    b, s = TRAIN_BATCH
    model = Model(cfg, device=dev, remat=True, use_kernels=False)
    runner = TrainRunner(
        model, DataConfig(batch=b, seq_len=s, seed=SEED),
        TrainConfig(micro_batches=TRAIN_MICRO),
        RunnerConfig(total_steps=TRAIN_STEPS, ckpt_every=10**9,
                     ckpt_dir=str(TRAIN_CKPT / "unused"), log_every=1))
    steps = []                 # (seconds, metrics) of each step
    step_fn = runner.train_step

    def timed_step(params, opt_state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0,
                      {k: float(v) for k, v in out[2].items()}))
        return out

    runner.train_step = timed_step
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = runner.run(torch.Generator(device=dev).manual_seed(SEED))
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(len(steps) == TRAIN_STEPS, f"train: {len(steps)} steps run")
    for i, (_, m) in enumerate(steps):
        check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
              f"train: step {i + 1} loss {m['loss']} |g| {m['grad_norm']}")
        check(i == 0 or m["skipped"] == 0.0, f"train: step {i + 1} skipped")
    check(not any(launches.values()),
          f"train: the plain training route launched kernels {launches}")
    step_s = float(np.mean([t for t, _ in steps[1:]]))
    tokens = b * s
    flops = 6 * cfg.param_count() * tokens
    out = {"phase": "train", "model": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "params": cfg.param_count(),
           "dtype": "float32", "tf32": False, "remat": True,
           "batch": [b, s], "micro_batches": TRAIN_MICRO,
           "steps": TRAIN_STEPS, "wall_s": wall,
           "step_s": [t for t, _ in steps],
           "loss": [m["loss"] for _, m in steps],
           "grad_norm": [m["grad_norm"] for _, m in steps],
           "skipped": [m["skipped"] for _, m in steps],
           "s_per_step": step_s, "tokens_per_s": tokens / step_s,
           "model_tflops": flops / step_s / 1e12,
           "peak_tflops": F32_FLOPS_PER_S / 1e12,
           "peak_held_to": "f32 outside the tensor cores (TF32 off)",
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches}
    del model, runner, result
    torch.cuda.empty_cache()
    out["crash_resume"] = [
        crash_resume(torch, dev, dataclasses.replace(cfg, n_layers=4),
                     DataConfig(batch=b, seq_len=s, seed=SEED)),
        crash_resume(torch, dev, get_smoke_config("qwen2.5-14b"),
                     DataConfig(batch=b, seq_len=64, seed=SEED))]
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    emit(out)
    return out


def crash_resume(torch, dev, cfg, data) -> dict:
    """An uninterrupted run of ``RESUME_STEPS`` steps, then a run that
    checkpoints every 2 steps and crashes after 3 (``crash_after``),
    then a run that resumes from its latest checkpoint (step 2) to the
    end: the resumed history, final parameters and optimizer state must
    equal the uninterrupted run's bit for bit (tolerance 0), with
    deterministic algorithms on for the three runs."""
    from repro_torch.distributed.checkpoint import (
        checkpoint_nbytes,
        latest_step,
    )
    from repro_torch.distributed.fault_tolerance import (
        InjectedFailure,
        RunnerConfig,
        TrainRunner,
    )
    from repro_torch.models.build import Model
    from repro_torch.training.train_loop import TrainConfig

    root = TRAIN_CKPT / cfg.name
    shutil.rmtree(root, ignore_errors=True)

    def run(ckpt_dir, ckpt_every, crash_after=None):
        model = Model(cfg, device=dev, remat=True, use_kernels=False)
        runner = TrainRunner(model, data,
                             TrainConfig(micro_batches=TRAIN_MICRO),
                             RunnerConfig(total_steps=RESUME_STEPS,
                                          ckpt_every=ckpt_every,
                                          ckpt_dir=str(ckpt_dir),
                                          crash_after=crash_after,
                                          log_every=1))
        return runner.run(torch.Generator(device=dev).manual_seed(SEED))

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        t0 = time.perf_counter()
        whole = run(root / "whole", 10**9)
        crashed = False
        try:
            run(root / "resumed", 2, crash_after=3)
        except InjectedFailure:
            crashed = True
        check(crashed, f"{cfg.name}: the run did not crash")
        check(latest_step(str(root / "resumed")) == 2,
              f"{cfg.name}: latest checkpoint "
              f"{latest_step(str(root / 'resumed'))}, not 2")
        ckpt_gb = checkpoint_nbytes(str(root / "resumed"), 2) / 1e9
        resumed = run(root / "resumed", 2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    check(resumed["resumed_from"] == 2,
          f"{cfg.name}: resumed from {resumed['resumed_from']}")
    check(resumed["history"] == whole["history"][2:],
          f"{cfg.name}: resumed history {resumed['history']} != "
          f"{whole['history'][2:]}")
    p1, p2 = whole["params"], resumed["params"]
    s1, s2 = whole["opt_state"], resumed["opt_state"]
    diffs = [float((p1[n].float() - p2[n].float()).abs().max()) for n in p1]
    diffs += [float((a[n] - b[n]).abs().max())
              for a, b in ((s1.mu, s2.mu), (s1.nu, s2.nu)) for n in a]
    diffs.append(float((s1.norm_ema - s2.norm_ema).abs()))
    check(max(diffs) == 0.0 and int(s1.step) == int(s2.step),
          f"{cfg.name}: resumed state differs from the uninterrupted run's "
          f"by {max(diffs)}")
    shutil.rmtree(root, ignore_errors=True)
    return {"model": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "batch": [data.batch, data.seq_len],
            "steps": RESUME_STEPS, "crash_after": 3, "resumed_from": 2,
            "checkpoint_gb": ckpt_gb, "max_abs_diff": max(diffs),
            "tol": 0.0, "final_loss": resumed["final_loss"], "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 17: the pod-axis gradient sync
# ---------------------------------------------------------------------------


def quantized_leaf(torch, grads: dict, names) -> list:
    """``dequantize(*quantize(g))`` of one leaf (its tensors quantized as
    one, as the JAX tree stacks them): what a 1-pod compressed sync must
    return, and the leaf's scale."""
    from repro_torch.distributed.compression import dequantize, quantize

    q, scale = quantize(torch.cat([grads[n].flatten() for n in names]))
    want = dequantize(q, scale).split([grads[n].numel() for n in names])
    return want, float(scale)


def train_pod_phase(torch, dev) -> dict:
    """(a) Full-width hubert-xlarge in f32 (TF32 off, stated),
    ``remat=True``, the plain attention, on a ``(pod 1, data 1, model
    1)`` mesh over a one-rank NCCL group, batch 8 x 512 in one pass:
    two plain value-and-grads (bitwise equal, or the checks below hold
    to one quantization step instead); the compressed value-and-grad's
    loss bitwise equal to the plain one and each leaf's gradient equal
    to ``dequantize(*quantize(g_plain))``; ``POD_STEPS`` compressed
    ``build_train_step`` steps with finite losses, then as many plain
    ones; no kernel launched.  Prints s/step both ways (after the first
    step), the sync's device and event ms, its payload bytes, leaves and
    collectives, and peak memory.  (b) ``pod_pair``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.distributed.compression import (
        pod_manual_value_and_grad,
        sync_pod_grads,
    )
    from repro_torch.kernels import ops
    from repro_torch.models.build import Model
    from repro_torch.models.convert import stacked_leaves
    from repro_torch.training.data import DataConfig, make_batch
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_loop import (
        TrainConfig,
        build_train_step,
        trained_params,
        value_and_grad,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("hubert-xlarge")
    b, s = TRAIN_BATCH
    data = DataConfig(batch=b, seq_len=s, seed=SEED)

    def batch(step):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in make_batch(cfg, data, step).items()}

    model = Model(cfg, device=dev, remat=True, use_kernels=False)
    model.init(torch.Generator(device=dev).manual_seed(SEED))
    params = trained_params(model)
    leaves = stacked_leaves(cfg, params)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        mesh = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=POD_AXES)
        group = mesh.get_group("pod")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        batch0 = batch(0)
        loss, grads = value_and_grad(model, params, batch0)
        loss2, grads2 = value_and_grad(model, params, batch0)
        deterministic = bool(torch.equal(loss, loss2)) and all(
            torch.equal(grads[n], grads2[n]) for n in grads)
        del grads2
        vg = pod_manual_value_and_grad(lambda p, bt: model.loss(bt), mesh,
                                       leaves=leaves)
        loss_c, grads_c = vg(params, batch0)
        check(bool(torch.equal(loss_c, loss)) or not deterministic,
              f"train_pod: compressed loss {float(loss_c)} != plain "
              f"{float(loss)}")
        worst = 0.0       # largest |error| in quantization steps
        for names in leaves:
            want, scale = quantized_leaf(torch, grads, names)
            for n, w in zip(names, want):
                if deterministic:
                    check(torch.equal(grads_c[n], w.view_as(grads_c[n])),
                          f"train_pod: {n}: compressed != "
                          f"dequantize(quantize(g_plain))")
                err = float((grads_c[n] - w.view_as(grads_c[n])).abs().max())
                worst = max(worst, err / scale)
        check(worst <= 1.0, f"train_pod: compressed gradient {worst} "
                            f"quantization steps from g_plain's")
        del grads_c

        # the sync alone, on the plain gradients (each call re-syncs the
        # last call's output: the same work)
        def sync():
            sync_pod_grads(grads, group, leaves=leaves)

        sync_device_ms = device_ms(torch, sync, iters=3)
        sync_event_ms = cuda_ms(torch, sync, iters=3, warmup=1)
        del grads

        def run(train_cfg, mesh_or_none):
            step_fn = build_train_step(model, train_cfg, mesh_or_none)
            opt_state = adamw_init(params)
            times, losses = [], []
            for i in range(POD_STEPS):
                bt = batch(i)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, opt_state, m = step_fn(params, opt_state, bt)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(float(m["loss"]))
            return times, losses

        c_times, c_losses = run(TrainConfig(grad_compression=True), mesh)
        check(all(np.isfinite(c_losses)),
              f"train_pod: compressed losses {c_losses}")
        p_times, p_losses = run(TrainConfig(), None)
        check(all(np.isfinite(p_losses)), f"train_pod: losses {p_losses}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches = ops.launch_counts()
    finally:
        dist.destroy_process_group()
    check(not any(launches.values()),
          f"train_pod: the plain training route launched kernels {launches}")
    n_elems = sum(p.numel() for p in params.values())
    out = {"phase": "train_pod", "model": cfg.name, "n_layers": cfg.n_layers,
           "params": n_elems, "dtype": "float32", "tf32": False,
           "remat": True, "batch": [b, s], "micro_batches": 1,
           "mesh": dict(zip(POD_AXES, (1, 1, 1))), "backend": "nccl",
           "deterministic": deterministic,
           "loss_bitwise": bool(torch.equal(loss_c, loss)),
           "max_err_quant_steps": worst,
           "leaves": len(leaves), "tensors": len(params),
           # per step: a max per leaf, a sum per tensor, the loss's mean
           "collectives": len(leaves) + len(params) + 1,
           "payload_bytes": 4 * n_elems + 4 * len(leaves),
           "sync_device_ms": sync_device_ms, "sync_event_ms": sync_event_ms,
           "step_s_compressed": c_times, "step_s_plain": p_times,
           "s_per_step_compressed": float(np.mean(c_times[1:])),
           "s_per_step_plain": float(np.mean(p_times[1:])),
           "loss_compressed": c_losses, "loss_plain": p_losses,
           "peak_mem_gb": peak, "launches": launches}
    out["sync_share"] = (out["sync_device_ms"] / 1e3
                         / out["s_per_step_compressed"])
    del model, params
    torch.cuda.empty_cache()
    out["two_pods"] = pod_pair(torch, dev, dataclasses.replace(
        cfg, n_layers=POD_LAYERS), data)
    emit(out)
    return out


def pod_pair(torch, dev, cfg, data) -> dict:
    """(b) Two pods sharing the card: two processes on ``cuda:0`` with a
    gloo group (NCCL refuses two ranks on one device; gloo stages the
    CUDA tensors through the host), ``cfg`` (hubert cut to
    ``POD_LAYERS`` layers at full width, f32) over ``data``'s batch split
    in two.  Against the one-process reference (saved to ``POD_DIR``):
    the mean of the two halves' losses and gradients, which is what the
    pod sync computes — hubert's masked loss divides by each block's own
    mask count, so the mean over the pods is not the whole batch's loss,
    in the JAX package too.  Loss within ``POD_TOL`` relative;
    uncompressed gradients within ``POD_TOL`` of each leaf's max |g|;
    compressed ones within half the leaf's shared scale of the reference
    plus that tolerance; after one compressed ``build_train_step`` both
    ranks' parameters bitwise equal.  Prints the gloo sync's wall ms,
    host-staged: not a speed of the card."""
    import torch.multiprocessing as mp

    from repro_torch.models.build import Model
    from repro_torch.training.data import make_batch
    from repro_torch.training.train_loop import trained_params, value_and_grad

    shutil.rmtree(POD_DIR, ignore_errors=True)
    POD_DIR.mkdir(parents=True)
    model = Model(cfg, device=dev, remat=True, use_kernels=False)
    model.init(torch.Generator(device=dev).manual_seed(SEED))
    half = data.batch // 2
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in make_batch(cfg, data, 0).items()}
    parts = [value_and_grad(model, trained_params(model),
                            {k: v[i * half:(i + 1) * half]
                             for k, v in batch.items()}) for i in range(2)]
    loss = (parts[0][0] + parts[1][0]) / 2
    grads = {n: (parts[0][1][n] + parts[1][1][n]) / 2 for n in parts[0][1]}
    torch.save({"loss": loss, "grads": grads}, POD_DIR / "reference.pt")
    del model, grads, parts
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ctx = mp.start_processes(pod_rank, args=(cfg, data), nprocs=2,
                             start_method="spawn", join=False)
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise AssertionError("train_pod: the two ranks ran over 300 s")
    wall = time.perf_counter() - t0
    codes = [proc.exitcode for proc in ctx.processes]
    check(codes == [0, 0], f"train_pod: rank exit codes {codes}")
    ranks = [json.loads((POD_DIR / f"rank{r}.json").read_text())
             for r in range(2)]
    shutil.rmtree(POD_DIR, ignore_errors=True)
    for r in ranks:
        check(r["loss_rel_err"] <= POD_TOL,
              f"train_pod: rank {r['rank']} loss rel err {r['loss_rel_err']}")
        check(r["plain_rel_err"] <= POD_TOL,
              f"train_pod: rank {r['rank']} uncompressed gradient rel err "
              f"{r['plain_rel_err']}")
        check(r["compressed_over_bound"] <= 1.0,
              f"train_pod: rank {r['rank']} compressed gradient at "
              f"{r['compressed_over_bound']} x its bound")
        check(r["params_equal_across_ranks"],
              f"train_pod: rank {r['rank']}: parameters differ across ranks")
        check(r["sync_matches_vg"], f"train_pod: rank {r['rank']}: the "
                                    f"timed sync != the value_and_grad's")
    return {"model": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "batch": [data.batch, data.seq_len],
            "split": [data.batch // 2] * 2, "backend": "gloo",
            "mesh": dict(zip(POD_AXES, (2, 1, 1))), "wall_s": wall,
            "tol": POD_TOL, "ranks": ranks}


def pod_rank(rank: int, cfg, data) -> None:
    """One of ``pod_pair``'s two ranks (a spawned process on ``cuda:0``):
    the uncompressed and the compressed value-and-grad on its half of
    the batch against the saved reference, the sync alone timed on the
    wall clock, one compressed train step, and whether the parameters
    after it equal the other rank's (their max and min over the ranks
    agree); writes ``rank{rank}.json`` to ``POD_DIR``."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.compression import (
        pod_manual_value_and_grad,
        sync_pod_grads,
        value_and_grad,
    )
    from repro_torch.models.build import Model
    from repro_torch.models.convert import stacked_leaves
    from repro_torch.training.data import make_batch
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_loop import (
        TrainConfig,
        build_train_step,
        trained_params,
    )

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(POD_DIR / "store"), 2), rank=rank,
        world_size=2, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cuda", (2, 1, 1), mesh_dim_names=POD_AXES)
        group = mesh.get_group("pod")
        ref = torch.load(POD_DIR / "reference.pt", map_location=dev)
        model = Model(cfg, device=dev, remat=True, use_kernels=False)
        model.init(torch.Generator(device=dev).manual_seed(SEED))
        params = trained_params(model)
        leaves = stacked_leaves(cfg, params)
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in make_batch(cfg, data, 0).items()}

        def loss_fn(p, bt):
            return model.loss(bt)

        loss_p, grads_p = pod_manual_value_and_grad(
            loss_fn, mesh, compress=False)(params, batch)
        loss_c, grads_c = pod_manual_value_and_grad(
            loss_fn, mesh, leaves=leaves)(params, batch)
        want = float(ref["loss"])
        out = {"rank": rank, "pod": mesh.get_local_rank("pod"),
               "loss_compressed": float(loss_c), "loss_plain": float(loss_p),
               "loss_reference": want,
               "loss_rel_err": max(abs(float(loss_c) - want),
                                   abs(float(loss_p) - want)) / abs(want)}
        # this pod's gradients alone, then the sync alone on the wall clock
        half = data.batch // 2
        _, local = value_and_grad(loss_fn)(
            params, {k: v[rank * half:(rank + 1) * half]
                     for k, v in batch.items()})
        scales = {}
        for names in leaves:
            m = torch.stack([local[n].abs().max() for n in names]).max()
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
            scales[names[0]] = max(float(m) / 127.0, 1e-12)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sync_pod_grads(local, group, leaves=leaves)
        torch.cuda.synchronize()
        out["sync_wall_ms"] = 1e3 * (time.perf_counter() - t0)
        out["sync_matches_vg"] = all(torch.equal(local[n], grads_c[n])
                                     for n in local)
        del local
        plain_err = over = 0.0
        for names in leaves:
            gmax = max(float(ref["grads"][n].abs().max()) for n in names)
            tol = POD_TOL * gmax
            bound = scales[names[0]] / 2 + tol
            for n in names:
                plain_err = max(plain_err, float(
                    (grads_p[n] - ref["grads"][n]).abs().max()) / max(gmax,
                                                                      1e-30))
                over = max(over, float(
                    (grads_c[n] - ref["grads"][n]).abs().max()) / bound)
        out["plain_rel_err"], out["compressed_over_bound"] = plain_err, over
        del grads_p, grads_c, ref
        step = build_train_step(model, TrainConfig(grad_compression=True),
                                mesh)
        _, _, metrics = step(params, adamw_init(params), batch)
        out["step_loss"] = float(metrics["loss"])
        same = True
        for p in params.values():
            hi, lo = p.detach().clone(), p.detach().clone()
            dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
            dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
            same = same and bool(torch.equal(hi, p)) and bool(
                torch.equal(lo, p))
        out["params_equal_across_ranks"] = same
        (POD_DIR / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# phases 12-13: kernel path vs plain path, the features on and off, f32
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


def top2_margin(torch, model, tokens) -> float:
    """Top-1 minus top-2 logit of the next token after ``tokens``,
    prefilled alone on the plain route in chunks of 256."""
    from repro_torch.serving.kv_manager import PagedKVManager

    n, chunk, ps = len(tokens), ENGINE["chunk_size"], ENGINE["page_size"]
    kv = PagedKVManager(1, n + 1, ps, device=model.device)
    caches = model.init_paged_cache(1, n + 1, ps, kv.n_pages)
    check(kv.ensure(0, n), "margin pool too small")
    use = model.use_kernels
    model.use_kernels = False
    for start in range(0, n, chunk):
        part = np.asarray(tokens[start:start + chunk], np.int32)
        logits, caches = model.chunk_step(
            caches, kv.device_table(),
            torch.as_tensor(part[None], device=model.device),
            torch.tensor([start], dtype=torch.int32, device=model.device),
            torch.tensor([len(part)], dtype=torch.int32,
                         device=model.device))
    model.use_kernels = use
    top = logits[0].float().topk(2).values
    return float(top[0] - top[1])


def feature_parity_phase(torch, dev, cfg) -> dict:
    """f32 with TF32 off, full-width qwen7b cut to 2 layers: the prefix
    cache on and off over 6 shared-prefix prompts served one after
    another, and speculation on and off over 4 repetitive prompts.
    Tokens must be identical; where they are not, the plain run's
    top-2 logit margin at the first divergence must be under
    ``FEATURE_TOL`` (the kernel-vs-plain tolerance of ``parity``): a
    near-tie that the other route's rounding may flip."""
    from repro_torch.core.request import Request
    from repro_torch.kernels import ops
    from repro_torch.models.build import Model
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    from repro_torch.serving.workload import (
        materialize_prompts,
        shared_prefix_workload,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = dataclasses.replace(cfg, n_layers=2)
    model = Model(small, dtype=torch.float32, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(SEED + 14))

    def prefix_prompts():
        reqs = shared_prefix_workload(n=6, n_groups=2, shape="chat",
                                      prefix_len=PREFIX_LEN,
                                      suffix_len=PREFIX_SUFFIX, seed=SEED)
        materialize_prompts(reqs, small.vocab_size, seed=SEED)
        return [r.prompt for r in reqs]

    def spec_prompts():
        rng = np.random.default_rng(SEED + 15)
        return [np.tile(rng.integers(0, small.vocab_size, SPEC_PHRASE)
                        .astype(np.int32), 8 + 4 * i) for i in range(4)]

    cases = {"prefix_cache": (prefix_prompts(), 16, True),
             "spec_decode": (spec_prompts(), 32, False)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    out, passes = {"phase": "feature_parity", "model": small.name,
                   "n_layers": 2, "d_model": small.d_model,
                   "dtype": "float32", "engine": FEATURE_ENGINE,
                   "tol": FEATURE_TOL}, 0
    for feature, (prompts, l_out, sequential) in cases.items():
        gen, eng_out = {}, {}
        for on in (True, False):
            extra = ({"prefix_cache": on} if feature == "prefix_cache"
                     else {"spec_decode": on, "max_spec_len": SPEC_MAX_LEN})
            engine = InferenceEngine(model, EngineConfig(**FEATURE_ENGINE,
                                                         **extra))
            reqs = [Request.from_prompt(i, p, l_out)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                engine.submit(r)
                if sequential:
                    engine.run_until_done()
            engine.run_until_done()
            check_served(reqs, "feature_parity")
            gen[on] = [list(r.generated) for r in reqs]
            passes += c1_passes(engine)
            eng_out[on] = (sum(r.prefix_hit_tokens for r in reqs)
                           if feature == "prefix_cache"
                           else engine.n_spec_dispatches)
            del engine
        diverged = divergences(torch, model, prompts, gen[True], gen[False])
        for d in diverged:
            check(d["margin"] < FEATURE_TOL,
                  f"feature_parity {feature}: tokens differ at "
                  f"{d['position']} with a top-2 margin of {d['margin']}")
        check(eng_out[True] > 0, f"feature_parity {feature}: the feature "
                                 f"did nothing ({eng_out[True]})")
        out[feature] = {"n": len(prompts), "identical": not diverged,
                        "diverged": diverged,
                        ("hit_tokens" if feature == "prefix_cache"
                         else "spec_dispatches"): eng_out[True]}
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check(launches["paged_decode_attention"] == small.n_layers * passes,
          "feature_parity: decode-attention launches do not match the "
          "C == 1 passes")
    out.update(c1_passes=passes, launches=launches,
               seconds=time.perf_counter() - t0)
    emit(out)
    del model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# --profile: where the time of a prefill chunk and of decode blocks goes
# ---------------------------------------------------------------------------


# the decode-attention kernels' functions: paged (group, split), the
# contiguous ring and split, and the merge they share
DECODE_ATTENTION_KERNELS = (PAGED_GROUP_KERNEL, "paged_decode_attention_split",
                            "decode_ring_kernel", "decode_attention_split",
                            "decode_merge_kernel")


# ---------------------------------------------------------------------------
# phase 19: the dry run's one-card cells measured
# ---------------------------------------------------------------------------


def dryrun_phase(torch, dev, model, smi: str) -> dict:
    """The meta-device dry run of three one-card cells against the same
    cells on the card (see the module docstring, phase 19); ``model`` is
    the loaded full-width bf16 qwen7b, whose parameters are the serving
    cells' own."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.models.build import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = MeshSpec(("data", "model"), (1, 1))
    ops.reset_launch_counts()

    def cell(name, cfg, shape, on_card, peak, iters):
        t0 = time.perf_counter()
        rec = dryrun.measure_cell(cfg, shape, mesh)
        dryrun.analyze_terms(rec, cfg, shape, mesh, peak_flops=peak)
        meta_s = time.perf_counter() - t0
        c = dryrun.build_cell(cfg, shape, mesh, model=on_card)
        allocated = sum(t.nbytes for t in c.args.values())
        c.step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c.step()
        torch.cuda.synchronize()
        peak_mem = torch.cuda.max_memory_allocated()
        ms = device_ms(torch, c.step, iters)
        bound_s = max(rec["compute_term_s"], rec["memory_term_s"])
        out = {"cell": name, "model": cfg.name, "kind": shape.kind,
               "batch": [shape.global_batch, shape.seq_len],
               "dtype": str(c.model.dtype).replace("torch.", ""),
               "argument_bytes": rec["memory"]["argument_bytes"],
               "allocated_bytes": allocated,
               "peak_mem_bytes": peak_mem, "device_ms": ms,
               "flops_per_device": rec["flops_per_device"],
               "bytes_per_device": rec["bytes_per_device"],
               "peak_flops": peak,
               "compute_term_s": rec["compute_term_s"],
               "memory_term_s": rec["memory_term_s"],
               "collective_term_s": rec["collective_term_s"],
               "bottleneck": rec["bottleneck"],
               "roofline_share": bound_s / (ms / 1e3),
               "useful_flops_ratio": rec["useful_flops_ratio"],
               "meta_s": meta_s, "nvidia_smi": smi}
        check(allocated == out["argument_bytes"],
              f"dryrun {name}: {allocated} bytes allocated, the dry run "
              f"counts {out['argument_bytes']}")
        check(out["roofline_share"] <= DRYRUN_SHARE_MAX,
              f"dryrun {name}: a step {ms} ms beats its lower bound "
              f"{1e3 * bound_s} ms (share {out['roofline_share']})")
        del c
        return out

    qwen = get_config("qwen7b")
    cells = [
        cell("qwen7b_prefill", qwen,
             ShapeSpec("prefill_8x512", DRYRUN_PREFILL[1],
                       DRYRUN_PREFILL[0], "prefill"),
             model, dryrun.PEAK_FLOPS, 3),
        cell("qwen7b_decode", qwen,
             ShapeSpec("decode_8x2048", DRYRUN_DECODE[1], DRYRUN_DECODE[0],
                       "decode"),
             model, dryrun.PEAK_FLOPS, 5),
    ]
    torch.cuda.empty_cache()
    hubert = get_config("hubert-xlarge")
    trainee = Model(hubert, device=dev, remat=True, use_kernels=False)
    trainee.init(torch.Generator(device=dev).manual_seed(SEED))
    cells.append(cell("hubert_train", hubert,
                      ShapeSpec("train_8x512", DRYRUN_TRAIN[1],
                                DRYRUN_TRAIN[0], "train"),
                      trainee, dryrun.F32_PEAK_FLOPS, 2))
    del trainee
    torch.cuda.empty_cache()
    launches = ops.launch_counts()
    for kernel in ("flash_attention", "decode_attention"):
        check(launches[kernel] > 0,
              f"dryrun: {kernel} never launched: {launches}")
    out = {"phase": "dryrun", "mesh": {"data": 1, "model": 1},
           "cells": cells, "launches": launches}
    emit(out)
    return out


def trace_summary(path: Path, wall_s: float) -> dict:
    """Device busy time (union of kernel intervals), kernel time by name,
    the decode-attention kernels' time and count, launch count and the
    CUDA runtime's synchronize and memcpy calls by name from a chrome
    trace of ``torch.profiler``."""
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
    attn = [e["dur"] / 1e3 for e in kernels
            if any(n in e["name"] for n in DECODE_ATTENTION_KERNELS)]
    return {"wall_ms": 1e3 * wall_s, "busy_ms": busy / 1e3,
            "decode_attention_ms": {"ms": sum(attn), "n": len(attn)},
            "idle_share": 1.0 - busy / 1e3 / (1e3 * wall_s),
            "n_kernels": len(kernels),
            "n_cpu_ops": sum(e.get("cat") == "cpu_op" for e in events),
            "sync_and_copy_calls": dict(Counter(
                e["name"] for e in events if e.get("cat") == "cuda_runtime"
                and ("Synchronize" in e["name"] or "Memcpy" in e["name"]))),
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
    return result


# ---------------------------------------------------------------------------
# phase 20: the port's examples
# ---------------------------------------------------------------------------


class KeptKernelCalls:
    """For the ``with`` block, each kernel dispatcher of ``ops`` (the
    functions the models and the KV manager call) keeps a copy of every
    call's tensors in and out, for :meth:`hold` to compare with the
    plain versions once the run is over."""

    NAMES = ("paged_decode_attention", "page_gather", "flash_attention",
             "decode_attention", "ssd", "rmsnorm", "paged_kv_write")
    # written in place: its inputs are kept from before the call, its
    # output is the two pools after it
    IN_PLACE = ("paged_kv_write",)

    def __init__(self, torch, ops):
        self.torch, self.ops = torch, ops
        self.calls = {name: [] for name in self.NAMES}

    def _copy(self, x):
        if isinstance(x, self.torch.Tensor):
            return x.detach().clone()
        if isinstance(x, tuple):
            return tuple(self._copy(y) for y in x)
        return x

    def _keeping(self, name, fn):
        def call(*args, **kw):
            before = self._copy(args) if name in self.IN_PLACE else None
            out = fn(*args, **kw)
            if before is not None:
                self.calls[name].append((before, kw, self._copy(args[:2])))
            else:
                self.calls[name].append((self._copy(args), kw,
                                         self._copy(out)))
            return out
        return call

    def __enter__(self):
        self.orig = {n: getattr(self.ops, n) for n in self.NAMES}
        for name, fn in self.orig.items():
            setattr(self.ops, name, self._keeping(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)

    def hold(self, label: str) -> dict:
        """Every kept call's output against the plain version on its
        inputs; per kernel: calls, dtypes, head dims (the last axis of
        the first input), the max abs error and the tolerance."""
        from repro_torch.kernels import ref

        torch = self.torch
        def plain_write(k_pages, v_pages, *rest):
            k_pages, v_pages = k_pages.clone(), v_pages.clone()
            ref.paged_kv_write_ref(k_pages, v_pages, *rest)
            return k_pages, v_pages

        plain = {"paged_decode_attention": ref.paged_decode_attention_ref,
                 "page_gather": ref.page_gather_ref,
                 "flash_attention": ref.flash_attention_ref,
                 "decode_attention": ref.decode_attention_ref,
                 "ssd": ref.ssd_ref, "rmsnorm": ref.rmsnorm_ref,
                 "paged_kv_write": plain_write}
        held = {}
        for name, kept in self.calls.items():
            if not kept:
                continue
            errs, dtypes, dims = [], set(), set()
            for args, kw, got in kept:
                dtype = str(args[0].dtype).removeprefix("torch.")
                dtypes.add(dtype)
                dims.add(int(args[0].shape[-1]))
                want = plain[name](*args, **kw)
                what = f"{label}: {name} on {dtype} " \
                       f"{tuple(args[0].shape)}"
                if name in ("page_gather", "paged_kv_write"):
                    pairs = (zip(got, want) if isinstance(got, tuple)
                             else [(got, want)])
                    check(all(torch.equal(g, w) for g, w in pairs),
                          f"{what}: not exact")
                    errs.append(0.0)
                    continue
                pairs = (zip(got, want) if isinstance(got, tuple)
                         else [(got, want)])
                errs += [compare(torch, g, w, self.tol(name, dtype),
                                 what)["max_abs_err"] for g, w in pairs]
            held[name] = {"calls": len(kept), "dtypes": sorted(dtypes),
                          "head_dims": sorted(dims),
                          "max_abs_err": max(errs),
                          "tol": {d: self.tol(name, d) for d in dtypes}}
        return held

    @staticmethod
    def tol(name: str, dtype: str) -> float:
        return (0.0 if name in ("page_gather", "paged_kv_write")
                else EXAMPLE_TOL[dtype])


def train_small_moved(torch, mod, ckpt: str, device="cuda") -> dict:
    """How far ``train_small``'s checkpoints moved its parameters from
    the weights its runner starts from (``seeded_model`` of ``SMALL``
    from seed 0, as ``Model.init`` draws them): per checkpoint step,
    the norm of the change over the norm of the start, and the least
    change of any one tensor (every one must have moved)."""
    from repro_torch.distributed.checkpoint import all_steps, load_checkpoint
    from repro_torch.models.build import seeded_model
    from repro_torch.training.train_loop import trained_params

    start = {f"params/{n}": p.detach() for n, p in
             trained_params(seeded_model(mod.SMALL, device, 0)).items()}
    norm0 = float(torch.sqrt(sum((p.float() ** 2).sum()
                                 for p in start.values())))
    moved = {}
    for step in all_steps(ckpt):
        flat, _ = load_checkpoint(ckpt, step, start, device=device)
        deltas = {k: float((flat[k].float() - p.float()).norm())
                  for k, p in start.items()}
        moved[step] = {"rel_change": float(np.sqrt(sum(
            d * d for d in deltas.values()))) / norm0,
            "least_tensor_change": min(deltas.values())}
    return moved


def examples_phase(torch, smi: str) -> dict:
    """Each of ``EXAMPLE_RUNS`` through its ``main(argv)`` on the card
    (the examples' default device), its printed lines sent to stderr,
    with the launch counts set to 0 just before it: every request
    served, the kernels of its path launched and no other, and every
    kernel call of the run held against the plain version on its own
    inputs (``KeptKernelCalls``); P/D's hand-offs all made;
    ``train_small``'s loss at its floor ln(vocab) while its gradient
    norm falls from step 1 to 100, every parameter tensor moved by its
    step-50 and step-100 checkpoints, and its second run resuming from
    step 100."""
    import contextlib
    import importlib
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.serving import engine as engine_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "examples"))
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="examples_train_small_",
                            dir=ROOT / "build")
    runs, total = [], Counter()
    t_phase = time.perf_counter()
    try:
        for label, name, argv, kernels in EXAMPLE_RUNS:
            argv = list(argv)
            if name == "train_small_torch":
                argv += ["--ckpt-dir", ckpt]
            mod = importlib.import_module(name)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            # decoded eagerly: a replayed graph calls no kernel wrapper,
            # so only an eager call can be held to the plain version
            with (KeptKernelCalls(torch, ops) as kept,
                  engine_mod._forced_eager(),
                  contextlib.redirect_stdout(sys.stderr)):
                out = mod.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: n for k, n in ops.launch_counts().items() if n}
            total.update(launches)
            row = {"run": label, "argv": argv, "wall_s": wall,
                   "launches": launches}
            idle = [k for k in kernels if not launches.get(k)]
            check(not idle, f"examples: {label} never launched {idle}")
            stray = sorted(set(launches) - set(kernels))
            check(not stray, f"examples: {label} launched {stray}")
            row["held"] = kept.hold(f"examples {label}")
            unheld = {k: n for k, n in launches.items()
                      if row["held"].get(k, {}).get("calls", 0) < n}
            check(not unheld, f"examples: {label}: launches {unheld} but "
                              f"calls kept {row['held']}")
            if name == "train_small_torch":
                hist = out["history"]
                row.update(
                    steps_run=out["steps_run"],
                    resumed_from=out["resumed_from"],
                    s_per_step=out["seconds"] / out["steps_run"],
                    tokens_per_s=out["steps_run"] * out["tokens_per_step"]
                    / out["seconds"],
                    first_loss=[hist[0]["step"], hist[0]["loss"]],
                    last_loss=[hist[-1]["step"], hist[-1]["loss"]],
                    final_loss=out["final_loss"],
                    first_grad_norm=hist[0]["grad_norm"],
                    last_grad_norm=hist[-1]["grad_norm"])
                check(np.isfinite(out["final_loss"]),
                      f"examples: {label} loss {out['final_loss']}")
                floor = float(np.log(mod.SMALL.vocab_size))
                check(all(abs(h["loss"] - floor) < EXAMPLE_LOSS_BAND
                          for h in hist),
                      f"examples: {label} loss left ln(vocab) {floor:.4f} "
                      f"+- {EXAMPLE_LOSS_BAND}: {hist}")
                if label == "train_small":
                    check(out["resumed_from"] == 0 and hist[0]["step"] == 1
                          and hist[-1]["step"] == 100
                          and hist[-1]["grad_norm"] < hist[0]["grad_norm"],
                          f"examples: {label} did not start fresh with its "
                          f"gradient norm falling from step 1 to 100: "
                          f"{out['resumed_from']}, {hist}")
                    row["moved"] = train_small_moved(torch, mod, ckpt)
                    check(sorted(row["moved"]) == [50, 100] and all(
                        m["least_tensor_change"] > 0
                        for m in row["moved"].values()),
                          f"examples: {label}: a parameter tensor did not "
                          f"move from its start: {row['moved']}")
                else:
                    check(out["resumed_from"] == 100
                          and out["steps_run"] == 20,
                          f"examples: {label} resumed from "
                          f"{out['resumed_from']}, ran {out['steps_run']}")
            else:
                row.update(served=out["served"], total=out["total"])
                check(out["total"] > 0 and out["served"] == out["total"],
                      f"examples: {label} served {out['served']} of "
                      f"{out['total']}")
            if "kv_transfers" in out:
                row.update(kv_transfers=out["kv_transfers"],
                           kv_bytes=out["kv_bytes"])
                check(out["kv_transfers"] == EXAMPLE_PD_TRANSFERS,
                      f"examples: {label} made {out['kv_transfers']} "
                      f"hand-offs, not {EXAMPLE_PD_TRANSFERS}")
            if "rejected" in out:
                row["rejected"] = out["rejected"]
            runs.append(row)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    out = {"phase": "examples", "nvidia_smi": smi,
           "wall_s": time.perf_counter() - t_phase, "runs": runs,
           "launches": {k: total.get(k, 0) for k in ops.launch_counts()}}
    emit(out)
    return out


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
    if "--train-pod" in sys.argv[1:]:
        print(smi, flush=True)
        train_pod_phase(torch, dev)
        return 0
    build_s = _build.build_all()
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", file=sys.stderr)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "build_s": build_s,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    emit({"phase": "tensor_cores", **tensor_core_report(_build)})
    emit({"phase": "decode_ring", **decode_ring_report(_build)})
    emit({"phase": "paged_group", **paged_group_report(_build)})

    def load(name: str, dtype=torch.bfloat16):
        t0 = time.perf_counter()
        model = Model(get_config(name), dtype=dtype, device=dev)
        model.init(torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        return model, time.perf_counter() - t0

    if "--dryrun" in sys.argv[1:]:
        model, _ = load("qwen7b")
        dryrun_phase(torch, dev, model, smi)
        return 0

    if "--decode-graph" in sys.argv[1:]:
        print(smi, flush=True)
        model, _ = load("qwen7b")
        decode_graph_phase(torch, dev, model, smi)
        return 0

    if "--examples" in sys.argv[1:]:
        print(smi, flush=True)
        examples_phase(torch, smi)
        return 0

    if "--placement" in sys.argv[1:]:
        print(smi, flush=True)
        placement_phase(torch)
        return 0

    if "--paged-variants" in sys.argv[1:]:
        emit(paged_variants(torch, dev))
        emit(paged_e2e(torch, dev))
        return 0

    if "--flash80-variants" in sys.argv[1:]:
        rest = sys.argv[sys.argv.index("--flash80-variants") + 1:]
        emit(flash80_variants(torch, dev, Path(rest[0]) if rest else None))
        return 0

    if "--profile" in sys.argv[1:]:
        for name, engine_kw, l_in in (("qwen7b", ENGINE, 512),
                                      ("gemma3-4b", SLOT_ENGINE, 1100),
                                      ("mamba2-2.7b", MAMBA_ENGINE, 1100),
                                      ("olmoe-1b-7b", ENGINE, 512),
                                      ("qwen32b", ENGINE, 512)):
            model, _ = load(name)
            profile_phase(torch, dev, model, engine_kw, l_in,
                          ROOT / "build" / "profile")
            del model
            torch.cuda.empty_cache()
        return 0

    rows = kernels_phase(torch, dev)

    model, init_s = load("qwen7b")
    serve = serve_phase(torch, dev, model, init_s)
    decode_graph = decode_graph_phase(torch, dev, model, smi)
    rows["paged_kv_write"] = decode_graph["paged_kv_write"]["decode"]
    pd = pd_phase(torch, dev, model)
    prefix = prefix_phase(torch, dev, model)
    spec = spec_phase(torch, dev, model)
    dry = dryrun_phase(torch, dev, model, smi)
    del model                  # free qwen7b before the clusters draw theirs
    torch.cuda.empty_cache()
    cluster = cluster_phase(torch, dev, "cluster")
    cluster_pd = cluster_phase(torch, dev, "cluster_pd")
    placement = placement_phase(torch)
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
    feature_parity = feature_parity_phase(torch, dev, get_config("qwen7b"))
    model, init_s = load("olmoe-1b-7b")
    moe_out = moe_phase(torch, dev, model, init_s)
    moe_pd = pd_phase(torch, dev, model, "moe_pd")
    del model
    torch.cuda.empty_cache()
    parity_phase(torch, dev, get_config("olmoe-1b-7b"))
    hubert = hubert_phase(torch, dev)
    train = train_phase(torch, dev)
    train_pod = train_pod_phase(torch, dev)
    # qwen32b's 65 GB of bf16 weights need the card to itself: every
    # other model is gone by now
    torch.cuda.reset_peak_memory_stats()
    model, init_s = load("qwen32b")
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    qwen32b = serve_phase(torch, dev, model, init_s, "qwen32b",
                          init_peak_mem_gb=init_peak_gb)
    # one prefill and two decode blocks of 8 x 512-token prompts traced:
    # a decode pass's device time and the paged kernel's share of it
    decode = profile_phase(torch, dev, model, ENGINE, 512,
                           ROOT / "build" / "profile")["decode"]
    passes = sum(k for kind, k, _ in decode["steps"] if kind == "decode")
    check(passes > 0, "qwen32b: the traced window holds no decode pass")
    emit({"phase": "qwen32b_decode", "passes": passes,
          "device_ms_per_pass": decode["busy_ms"] / passes,
          "paged_ms_per_pass": decode["decode_attention_ms"]["ms"] / passes,
          "paged_launches_per_pass": decode["decode_attention_ms"]["n"]
          / passes,
          "paged_share": decode["decode_attention_ms"]["ms"]
          / decode["busy_ms"], "idle_share": decode["idle_share"]})
    del model
    torch.cuda.empty_cache()
    examples = examples_phase(torch, smi)

    # launches: the main paths' runs, each with the counts set to 0 just
    # before it (the kernels phase's comparisons are not counted)
    main_paths = {"serve": serve, "decode_graph": decode_graph, "pd": pd,
                  "prefix": prefix, "spec": spec,
                  "cluster": cluster, "cluster_pd": cluster_pd,
                  "placement": placement, "slot": slot,
                  "mamba": mamba, "hybrid": hybrid, "hybrid_pd": hybrid_pd,
                  "feature_parity": feature_parity, "moe": moe_out,
                  "moe_pd": moe_pd, "hubert": hubert, "train": train,
                  "train_pod": train_pod, "qwen32b": qwen32b, "dryrun": dry,
                  "examples": examples}
    csrc = "src/repro_torch/kernels/csrc"
    kernels = []
    for name, replaces in (
        ("paged_decode_attention", "src/repro/kernels/decode_attention.py:167"),
        ("page_gather", "src/repro/kernels/page_gather.py:35"),
        ("flash_attention", "src/repro/kernels/flash_attention.py:95"),
        ("decode_attention", "src/repro/kernels/decode_attention.py:69"),
        ("ssd", "src/repro/kernels/ssd.py:86"),
        ("rmsnorm", "src/repro/kernels/rmsnorm.py:32"),
        # port-only: the JAX package's dropping scatter has no kernel
        ("paged_kv_write", None),
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
    # hubert's D 80 instance beside the gemma3 shape the row reports
    flash_cases = rows["flash_attention"]["cases"]
    flash_row = next(k for k in kernels if k["name"] == "flash_attention")
    flash_row["hubert_d80"] = {
        name: {k: flash_cases[name][k]
               for k in ("ms", "fma_ms", "plain_ms", "library_ms",
                         "bound_ms", "bound_by", "max_abs_err", "shape")}
        for name in ("hubert_d80_bf16", "hubert_d80_ragged1000_bf16")}
    # qwen32b's GQA 40 / 8, llama70b's 64 / 8 and zamba2's D 112 beside
    # the MHA shape the paged row reports, each with the split kernel's
    # time in turns
    paged_cases = rows["paged_decode_attention"]["cases"]
    paged_row = next(k for k in kernels
                     if k["name"] == "paged_decode_attention")
    paged_keys = ("ms", "legacy_ms", "plain_ms", "library_ms", "event_ms",
                  "legacy_event_ms", "bound_ms", "bound_by", "max_abs_err",
                  "route", "shape")
    paged_row["legacy_ms"] = rows["paged_decode_attention"]["legacy_ms"]
    for key, case in (("gqa40_8", "gqa40_8_bf16"), ("gqa64_8", "gqa64_8_bf16"),
                      ("zamba2_d112", "zamba2_d112_bf16")):
        paged_row[key] = {k: paged_cases[case][k] for k in paged_keys}
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
