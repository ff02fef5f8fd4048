"""Multi-pod dry run of the port: every (arch x shape x mesh) cell on
PyTorch's ``meta`` device (counterpart of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both

JAX lowers and compiles each cell with XLA on 512 placeholder devices
and reads XLA's analyses.  The port has no partitioner and no compiler
to ask, so a cell is built at full width on the ``meta`` device (shapes
and dtypes, no storage) and its numbers come from the sharding plan
(:func:`repro_torch.distributed.sharding.arch_rules`) and from the step
itself:

- ``memory.argument_bytes`` is exact: the sum, over every argument
  JAX's cell passes (train: f32 params, AdamW state and the batch;
  prefill: bf16 params, tokens or frames, lens; decode: bf16 params,
  the cache, tokens and pos), of that argument's per-device shard
  (:meth:`AxisRules.shard_shape`).  ``memory.output_bytes`` is the
  step's outputs' shards.  XLA's temp bytes (its buffer assignment) have
  no meta counterpart and are left out (``memory_method``).
- FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s count of the
  step on the plain path (``use_kernels=False``): ``forward`` + ``loss``
  + backward with remat for train (the port's ``build_train_step``),
  ``prefill``, ``decode_step``.  It counts products (matmuls, einsums,
  convolutions) where XLA's ``cost_analysis`` also counts elementwise
  work.  Per device: the count over the shards that split the work,
  the batch axes times the model axis (``flops_method``).
- Bytes per device are a lower bound: each argument read once (an
  untied embedding table only at the rows a prefill or decode step looks
  up) and each output written once (``bytes_method``).
- Collective bytes come from the plan (``collective_method``): FSDP
  all-gathers of the weights, the gradient reduce-scatter or all-reduce
  over the data axes, the tensor-parallel all-reduces of the layers'
  outputs, and the int8 pod sync's int32 payload; an all-reduce counts
  twice on the link (ring), as :func:`parse_collectives` counts it.

The roofline terms take an H100 SXM's published peaks.  A 256- or
512-card cell is a plan: nothing in it was measured.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import time
import traceback
from typing import Callable

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config, mfu_flops
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.sharding import (
    AxisRules,
    _axis_size,
    arch_rules,
    mesh_sizes,
    plan_arch,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.build import Model
from repro_torch.training.data import DataConfig, batch_spec, make_batch
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_loop import (
    TrainConfig,
    build_train_step,
    trained_params,
)

# ---------------------------------------------------------------------------
# Hardware constants (NVIDIA H100 SXM data sheet, dense, at 700 W) for the
# roofline terms
# ---------------------------------------------------------------------------
PEAK_FLOPS = 989e12      # bf16 / card, tensor cores
F32_PEAK_FLOPS = 67e12   # f32 / card, CUDA cores (TF32 off)
HBM_BW = 3.35e12         # bytes/s / card
LINK_BW = 450e9          # bytes/s / card, one direction of NVLink 4's 900 GB/s

_DTYPE_BYTES = {
    "f64": 8, "u64": 8, "s64": 8, "f32": 4, "u32": 4, "s32": 4,
    "bf16": 2, "f16": 2, "u16": 2, "s16": 2,
    "u8": 1, "s8": 1, "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLL_RE = re.compile(
    r"=\s*(.*?)\s*(all-reduce|all-gather|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start|-done)?\("
)

FLOPS_METHOD = ("FlopCounterMode's matmul/einsum/conv FLOPs of the whole "
                "step on meta (plain path; train: loss, backward with remat "
                "recompute), divided by the batch axes' shards x the model "
                "axis")
BYTES_METHOD = ("lower bound: every argument's shard read once (an untied "
                "embedding table only at the rows a prefill/decode looks "
                "up) + every output's shard written once (decode: the one "
                "new K/V position of an attention cache)")
MEMORY_METHOD = ("argument_bytes exact (each argument's per-device shard "
                 "under arch_rules); output_bytes the outputs' shards; no "
                 "temp bytes (XLA's buffer assignment has no meta "
                 "counterpart)")
COLLECTIVE_METHOD = ("from the plan: FSDP all-gathers of the weights (train "
                     "2, serving 1), gradient reduce-scatter (FSDP) or "
                     "all-reduce over the data axes, one all-reduce of a "
                     "layer half's (B, S, d) bf16 output per tensor-parallel "
                     "matmul (train: forward, backward and the remat "
                     "recompute), the pod sync's int32 payload and f32 max "
                     "per tensor; all-reduce x2 on the link")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def parse_collectives(hlo_text: str) -> dict:
    """Sum collective payload bytes (per-device module) by op kind."""
    out = {k: {"bytes": 0, "count": 0} for k in _COLL_KINDS}
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        if "-done(" in line:
            continue  # async pair: count the -start only
        result_type, kind = m.group(1), m.group(2)
        out[kind]["bytes"] += _shape_bytes(result_type)
        out[kind]["count"] += 1
    # effective on-link bytes: ring all-reduce moves ~2x payload
    link_bytes = sum(
        v["bytes"] * (2.0 if k == "all-reduce" else 1.0)
        for k, v in out.items()
    )
    out["link_bytes"] = link_bytes
    return out


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------


def stage_of(shape: ShapeSpec) -> str:
    if shape.kind in ("train", "prefill"):
        return shape.kind
    return "decode_long" if shape.seq_len > 100_000 else "decode"


@dataclasses.dataclass
class Cell:
    """One (config, shape, mesh) step, built and ready to run.

    ``args`` holds every tensor the step takes, by a flat name
    (``params/…``, ``opt/mu/…``, ``batch/…``, ``cache/{layer}/…``,
    ``tokens``, ``lens``, ``pos``), and ``axes`` their logical axes;
    ``step()`` runs the step once on them."""

    cfg: ModelConfig
    shape: ShapeSpec
    stage: str
    plan: dict
    rules: AxisRules
    model: Model
    args: dict
    axes: dict
    step: Callable[[], object]
    compress: bool = False


def _input(shape, dtype, device, high: int = 0):
    """A step input: shapes only on meta; else token ids below ``high``
    (int32) or standard-normal values in ``dtype``, from a fixed seed."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    rng = np.random.default_rng(0)
    if high:
        arr = rng.integers(0, high, shape).astype(np.int32)
    else:
        arr = rng.standard_normal(shape, np.float32)
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
               compress: bool = False, fsdp: bool = True,
               shard_residual=None, remat: bool = True,
               q_chunk: int = 512, train_kv_repeat: bool = False,
               device="meta", model: Model | None = None) -> Cell:
    """The cell's model and arguments on ``device`` (``meta``: shapes
    only), as JAX's ``build_cell`` passes them.  ``model`` reuses a
    model already built with the cell's dtype and knobs (its
    parameters are the cell's); otherwise one is built on ``device``
    with the plan's knobs, ``use_kernels=False``."""
    plan = plan_arch(cfg, mesh)
    stage = stage_of(shape)
    train = shape.kind == "train"
    rules = arch_rules(
        cfg, mesh, stage=stage, fsdp=fsdp,
        exclude_pod=compress and train,
        shard_residual=shard_residual,
        batch_size=shape.global_batch,
    )
    dtype = torch.float32 if train else torch.bfloat16
    kv_repeat = (plan["kv_repeat"] if (train_kv_repeat or not train)
                 else 1)
    if model is None:
        model = Model(cfg, dtype=dtype, device=device, use_kernels=False,
                      remat=remat and train, kv_repeat=kv_repeat,
                      q_chunk=q_chunk, vocab_pad=plan["vocab_pad"])
    else:
        device = model.device
        got = (model.dtype, model.kv_repeat, model.vocab_pad)
        if got != (dtype, kv_repeat, plan["vocab_pad"]):
            raise ValueError(f"the model's (dtype, kv_repeat, vocab_pad) "
                             f"{got} are not the cell's "
                             f"{(dtype, kv_repeat, plan['vocab_pad'])}")
    b, s = shape.global_batch, shape.seq_len
    params = trained_params(model)
    args = {f"params/{n}": p for n, p in params.items()}
    p_axes = model.param_axes()
    axes = {f"params/{n}": p_axes[n] for n in params}
    frames = cfg.frontend == "frames"

    if train:
        opt = adamw_init(params)
        for part in ("mu", "nu"):
            for n, t in getattr(opt, part).items():
                args[f"opt/{part}/{n}"] = t
                axes[f"opt/{part}/{n}"] = p_axes[n]
        args["opt/step"], axes["opt/step"] = opt.step, ()
        args["opt/norm_ema"], axes["opt/norm_ema"] = opt.norm_ema, ()
        data = DataConfig(batch=b, seq_len=s)
        if torch.device(device).type == "meta":
            batch = batch_spec(cfg, data)
        else:
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in make_batch(cfg, data, 0).items()}
        for k, t in batch.items():
            args[f"batch/{k}"] = t
            axes[f"batch/{k}"] = (("batch", "seq", "embed") if k == "frames"
                                  else ("batch", "seq"))
        step_fn = build_train_step(
            model, TrainConfig(grad_compression=compress))

        def step():
            return step_fn(params, opt, batch)

        return Cell(cfg, shape, stage, plan, rules, model, args, axes, step,
                    compress)

    if shape.kind == "prefill":
        if frames:
            tokens = _input((b, s, cfg.d_model), torch.bfloat16, device)
            axes["tokens"] = ("batch", "seq", "embed")
        else:
            tokens = _input((b, s), torch.int32, device, cfg.vocab_size)
            axes["tokens"] = ("batch", "seq")
        lens = torch.full((b,), s, dtype=torch.int32, device=device)
        args["tokens"], args["lens"] = tokens, lens
        axes["lens"] = ("batch",)

        def step():
            return model.prefill(tokens, lens)

        return Cell(cfg, shape, stage, plan, rules, model, args, axes, step)

    # decode: one token a row at the cache's last position, so the step
    # reads every cached position.  ``pos`` is an argument only where an
    # attention layer reads it: jax.jit drops an argument its step never
    # reads (an attention-free model's decode)
    cache = model.init_cache(b, s)
    for i, (layer, layer_axes) in enumerate(zip(cache,
                                                model.cache_logical_axes())):
        for k, t in layer.items():
            args[f"cache/{i}/{k}"] = t
            axes[f"cache/{i}/{k}"] = layer_axes[k]
    tokens = _input((b,), torch.int32, device, cfg.vocab_size)
    pos = torch.full((b,), s - 1, dtype=torch.int32, device=device)
    args["tokens"], axes["tokens"] = tokens, ("batch",)
    if model.n_attn:
        args["pos"], axes["pos"] = pos, ("batch",)

    def step():
        return model.decode_step(cache, tokens, pos)

    return Cell(cfg, shape, stage, plan, rules, model, args, axes, step)


# ---------------------------------------------------------------------------
# Analysis
# ---------------------------------------------------------------------------


def shard_bytes(rules: AxisRules, shape, logical, itemsize: int) -> int:
    return math.prod(rules.shard_shape(shape, logical)) * itemsize


def argument_bytes(cell: Cell) -> int:
    """Per-device bytes of every argument of the step (exact)."""
    return sum(shard_bytes(cell.rules, t.shape, cell.axes[n],
                           t.element_size())
               for n, t in cell.args.items())


def _output_bytes(cell: Cell) -> int:
    """Per-device bytes the step writes: train the new params and AdamW
    state; prefill the last position's logits and the caches; decode the
    logits, the new token's K/V and pos in each attention cache and the
    whole state of each Mamba-2 layer."""
    cfg, rules, model = cell.cfg, cell.rules, cell.model
    if cell.stage == "train":
        return sum(shard_bytes(rules, t.shape, cell.axes[n],
                               t.element_size())
                   for n, t in cell.args.items()
                   if not n.startswith("batch/"))
    b, s = cell.shape.global_batch, cell.shape.seq_len
    v = cfg.vocab_size + model.vocab_pad
    out = shard_bytes(rules, (b, v), ("batch", "vocab"), 2)
    if cell.stage == "prefill":
        if cfg.is_encoder_only:
            return out
        cache = model.init_cache(b, s, device="meta")
        for layer, layer_axes in zip(cache, model.cache_logical_axes()):
            for k, t in layer.items():
                out += shard_bytes(rules, t.shape, layer_axes[k],
                                   t.element_size())
        return out
    for i, (kind, layer_axes) in enumerate(zip(model.kinds,
                                               model.cache_logical_axes())):
        for k, logical in layer_axes.items():
            t = cell.args[f"cache/{i}/{k}"]
            shape = tuple(t.shape)
            if kind != "mamba":      # one position of each row is written
                shape = shape[:2] + (1,) + shape[3:]
            out += shard_bytes(rules, shape, logical, t.element_size())
    return out


def bytes_per_device(cell: Cell, arg_bytes: int, out_bytes: int) -> int:
    """:data:`BYTES_METHOD`: arguments read once, outputs written once;
    a token model's untied embedding table is read at the looked-up
    rows only outside train (where AdamW reads all of it), and a frames
    model's not at all."""
    cfg, rules = cell.cfg, cell.rules
    read = arg_bytes
    table = cell.args["params/embed"]
    if cell.stage != "train" and (not cfg.tie_embeddings
                                  or cfg.frontend == "frames"):
        whole = shard_bytes(rules, table.shape, cell.axes["params/embed"],
                            table.element_size())
        rows = 0
        if cfg.frontend != "frames":
            tok = cell.args["tokens"]
            rows = math.prod(rules.shard_shape(tok.shape, cell.axes["tokens"]))
        read += min(whole, rows * cfg.d_model * table.element_size()) - whole
    return read + out_bytes


def plan_collectives(cell: Cell) -> dict:
    """Collective payload bytes per device, by kind, from the plan
    (:data:`COLLECTIVE_METHOD`), in :func:`parse_collectives`' form."""
    rules, sizes = cell.rules, mesh_sizes(cell.rules.mesh)
    mp = rules.mapping
    out = {k: {"bytes": 0, "count": 0} for k in _COLL_KINDS}

    def add(kind, nbytes, count=1):
        if nbytes > 0 and count > 0:
            out[kind]["bytes"] += int(nbytes) * count
            out[kind]["count"] += count

    train = cell.stage == "train"
    params = {n: t for n, t in cell.args.items() if n.startswith("params/")}
    no_fsdp = AxisRules(dict(mp, fsdp=None), rules.mesh)
    fsdp_ways = _axis_size(sizes, mp["fsdp"])
    data_ways = _axis_size(sizes, mp["batch"])
    for n, t in params.items():
        logical = cell.axes[n]
        gathered = shard_bytes(no_fsdp, t.shape, logical, t.element_size())
        shard = shard_bytes(rules, t.shape, logical, t.element_size())
        if fsdp_ways > 1 and "fsdp" in logical:
            add("all-gather", gathered, 2 if train else 1)
        if not train:
            continue
        if fsdp_ways > 1 and "fsdp" in logical:
            add("reduce-scatter", shard)
        elif data_ways > 1:
            add("all-reduce", gathered)
    if cell.compress and "pod" in sizes and sizes["pod"] > 1:
        elems = sum(math.prod(rules.shard_shape(t.shape, cell.axes[n]))
                    for n, t in params.items())
        add("all-reduce", 4 * elems)              # the int32 sum
        add("all-reduce", 4, len(params))         # the f32 max per tensor
    # tensor-parallel outputs: (B / batch shards, S, d) in bf16
    b, s = cell.shape.global_batch, cell.shape.seq_len
    tokens = -(-b // data_ways) * (1 if cell.stage.startswith("decode")
                                   else s)
    act = tokens * cell.cfg.d_model * 2
    passes = (3 if cell.model.remat else 2) if train else 1
    n_tp = 0
    for kind in cell.model.kinds:
        if kind == "mamba":
            n_tp += mp["ssm_inner"] is not None
            continue
        n_tp += mp["heads"] is not None
        if kind == "moe":
            n_tp += mp["experts"] is not None or mp["ff"] is not None
        else:
            n_tp += mp["ff"] is not None
    if sizes.get("model", 1) > 1:
        add("all-reduce", act, n_tp * passes)
    link = sum(v["bytes"] * (2.0 if k == "all-reduce" else 1.0)
               for k, v in out.items())
    return {"detail": out, "link_bytes": link}


def count_flops(cell: Cell) -> int:
    """FlopCounterMode's FLOPs of one run of the cell's step."""
    with FlopCounterMode(display=False) as fc:
        cell.step()
    return int(fc.get_total_flops())


def work_shards(cell: Cell) -> int:
    """The shards that split a step's work: the batch axes x model."""
    sizes = mesh_sizes(cell.rules.mesh)
    return (_axis_size(sizes, cell.rules.mapping["batch"])
            * sizes.get("model", 1))


def measure_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
                 flops: bool = True, flops_cache: dict | None = None,
                 **kw) -> dict:
    """Build the cell on meta and measure it: memory, bytes, collectives
    and (with ``flops``) FLOPs per device, each under its method.  A
    step's global count depends on the model and the shape alone, not
    on the mesh: ``flops_cache`` keeps it for the next mesh's cell."""
    rec: dict = {}
    t0 = time.time()
    cell = build_cell(cfg, shape, mesh, **kw)
    rec["build_s"] = round(time.time() - t0, 1)
    rec["plan"] = cell.plan
    args_b = argument_bytes(cell)
    out_b = _output_bytes(cell)
    rec["memory"] = {"argument_bytes": args_b, "output_bytes": out_b}
    rec["memory_method"] = MEMORY_METHOD
    rec["bytes_per_device"] = bytes_per_device(cell, args_b, out_b)
    rec["bytes_method"] = BYTES_METHOD
    coll = plan_collectives(cell)
    rec["collective_bytes_per_device"] = coll["link_bytes"]
    rec["collectives"] = coll["detail"]
    rec["collective_method"] = COLLECTIVE_METHOD
    rec["flops_per_device"] = None
    if flops:
        m = cell.model
        key = (cfg, shape, m.dtype, m.kv_repeat, m.q_chunk, m.vocab_pad,
               m.remat)
        cache = {} if flops_cache is None else flops_cache
        t1 = time.time()
        if key not in cache:
            cache[key] = count_flops(cell)
        total = cache[key]
        rec["flops_s"] = round(time.time() - t1, 1)
        rec["flops_total"] = total
        rec["work_shards"] = work_shards(cell)
        rec["flops_per_device"] = total / rec["work_shards"]
        rec["flops_method"] = FLOPS_METHOD
    return rec


def analyze_terms(rec: dict, cfg: ModelConfig, shape: ShapeSpec, mesh,
                  peak_flops: float = PEAK_FLOPS) -> None:
    chips = math.prod(mesh_sizes(mesh).values())
    rec["chips"] = chips
    rec["peak_flops"] = peak_flops
    rec["compute_term_s"] = rec["flops_per_device"] / peak_flops
    rec["memory_term_s"] = rec["bytes_per_device"] / HBM_BW
    rec["collective_term_s"] = (
        rec["collective_bytes_per_device"] / LINK_BW
    )
    terms = {
        "compute": rec["compute_term_s"],
        "memory": rec["memory_term_s"],
        "collective": rec["collective_term_s"],
    }
    rec["bottleneck"] = max(terms, key=terms.get)
    model_flops = mfu_flops(cfg, shape)
    rec["model_flops"] = model_flops
    total_hlo = rec["flops_per_device"] * chips
    rec["useful_flops_ratio"] = (
        model_flops / total_hlo if total_hlo > 0 else 0.0
    )
    # roofline fraction: ideal time of the dominant resource over the
    # sum of all three (a serial, no-overlap pessimistic bound)
    tsum = sum(terms.values())
    rec["roofline_fraction"] = (
        max(terms.values()) / tsum if tsum > 0 else 0.0
    )


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             pad_heads: int = 0, moe_groups: int = 0, flops: bool = True,
             flops_cache: dict | None = None, **kw) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))

    # hillclimb knobs: pad attention heads to the TP degree / grouped
    # MoE dispatch (groups aligned with the data shards)
    run_cfg = cfg
    if pad_heads:
        run_cfg = dataclasses.replace(run_cfg, n_heads=cfg.n_heads + pad_heads)
    if moe_groups and cfg.moe is not None:
        run_cfg = dataclasses.replace(
            run_cfg, moe=dataclasses.replace(cfg.moe,
                                             dispatch_groups=moe_groups))
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": mesh_sizes(mesh),
        "options": dict(kw),
    }
    if pad_heads:
        rec["options"]["pad_heads"] = pad_heads
    if moe_groups:
        rec["options"]["moe_groups"] = moe_groups
    t0 = time.time()
    try:
        rec.update(measure_cell(run_cfg, shape, mesh, flops=flops,
                                flops_cache=flops_cache, **kw))
        # model_flops / useful ratio always judged against the
        # *published* config — padding counts as overhead
        if flops:
            analyze_terms(rec, cfg, shape, mesh)
        rec["status"] = "ok"
    except Exception as e:      # one cell's failure is recorded, not fatal
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="runs/dryrun.jsonl")
    ap.add_argument("--compress", action="store_true",
                    help="int8 cross-pod gradient sync (train cells)")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-residual-shard", action="store_true")
    ap.add_argument("--q-chunk", type=int, default=512)
    ap.add_argument("--pad-heads", type=int, default=0)
    ap.add_argument("--moe-groups", type=int, default=0)
    ap.add_argument("--train-kv-repeat", action="store_true",
                    help="repeat KV heads to the TP degree in train "
                         "cells (fixes uneven GQA head sharding)")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = (list(ASSIGNED_ARCHS) if args.arch == "all"
             else args.arch.split(","))
    meshes = (["single", "multi"] if args.mesh == "both"
              else [args.mesh])

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    seen = set()
    if args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("status") == "ok":
                        seen.add((r["arch"], r["shape"], r["mesh"]))
                except json.JSONDecodeError:
                    pass

    kw = dict(
        compress=args.compress,
        fsdp=not args.no_fsdp,
        remat=not args.no_remat,
        shard_residual=(False if args.no_residual_shard else None),
        q_chunk=args.q_chunk,
        pad_heads=args.pad_heads,
        moe_groups=args.moe_groups,
        train_kv_repeat=args.train_kv_repeat,
    )
    n_ok = n_fail = 0
    flops_cache: dict = {}
    t_all = time.time()
    with open(args.out, "a") as f:
        for arch in archs:
            cfg = get_config(arch)
            shapes = ([s.name for s in cfg.shapes()]
                      if args.shape == "all" else args.shape.split(","))
            for shape_name in shapes:
                for mesh_kind in meshes:
                    key = (arch, shape_name, mesh_kind)
                    if key in seen:
                        continue
                    rec = run_cell(arch, shape_name, mesh_kind,
                                   flops_cache=flops_cache, **kw)
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
                    ok = rec["status"] == "ok"
                    n_ok += ok
                    n_fail += not ok
                    msg = (
                        f"[{'OK' if ok else 'FAIL'}] {arch} x {shape_name}"
                        f" x {mesh_kind} ({rec['total_s']}s)"
                    )
                    if ok:
                        msg += (
                            f" bottleneck={rec['bottleneck']}"
                            f" c={rec['compute_term_s']:.3e}"
                            f" m={rec['memory_term_s']:.3e}"
                            f" x={rec['collective_term_s']:.3e}"
                            f" useful={rec['useful_flops_ratio']:.2f}"
                        )
                    else:
                        msg += " " + rec.get("error", "")[:200]
                    print(msg, flush=True)
            # documented skips
            for sname, why in cfg.skipped_shapes():
                if args.shape == "all":
                    print(f"[SKIP] {arch} x {sname}: {why}", flush=True)
    print(f"dry-run complete: {n_ok} ok, {n_fail} fail "
          f"({time.time() - t_all:.1f}s)")


if __name__ == "__main__":
    main()
