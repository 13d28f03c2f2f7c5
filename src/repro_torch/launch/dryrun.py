"""Multi-pod dry run, the port of ``repro.launch.dryrun``: trace one step
of an (arch x shape) cell on a production mesh and report its per-rank
memory, cost, collectives and roofline, allocating nothing.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch qwen2-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod  # 2x16x16
    PYTHONPATH=src python -m repro_torch.launch.dryrun              # all

The mesh's ranks are the ``fake`` backend's group in this one process
(as the reference runs on 512 fake host devices), and every tensor is on
the ``meta`` device: the state, batch and caches are ``DTensor``s laid
out by ``launch.sharding``, and the step runs on their local shards under
``analysis.Trace``, which counts each rank's FLOPs, bytes and collective
bytes, and lists its largest collectives by kind and shape
(``collectives_by_shape``).  The port traces the whole depth, so the
reference's two-probe per-layer extrapolation has no counterpart.
Results land in ``build/dryrun/<arch>__<shape>__<mesh>.json`` (``--out``
to change).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch import configs
from repro_torch.launch import analysis, sharding as shd, steps as steps_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import build_model

RESULTS_DIR = os.path.join("build", "dryrun")

# why the reference's temp_size_in_bytes has no counterpart here
NO_TEMP = ("not traced: the meta device allocates nothing, and the port "
           "keeps no per-rank allocator model of its eager ops")


def _bytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _tree_bytes(tree, shardings) -> int:
    """Per-rank bytes of ``tree``'s tensors laid out by ``shardings`` (the
    same structure)."""
    if isinstance(tree, torch.Tensor):
        return _bytes(shardings.shard_shape(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return sum(_tree_bytes(v, shardings[k]) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v, s) for v, s in zip(tree, shardings))
    return 0


def argument_bytes(model, shape, mesh, hyper=None) -> int:
    """Per-rank bytes of the step's arguments: the train state and batch
    (train), or the parameters, batch and caches (prefill / decode)."""
    cfg, plan = model.cfg, model.plan
    batch = steps_lib.input_specs(cfg, shape)
    total = _tree_bytes(batch, shd.data_shardings(batch, mesh))
    if shape.kind == "train":
        state = steps_lib.abstract_train_state(model, hyper)
        sh = steps_lib.train_state_shardings(model, mesh, hyper)
        total += _tree_bytes(state["params"], sh["params"])
        opt, osh = state["opt"], sh["opt"]
        for leaf in ("m", "v", "master"):
            total += _tree_bytes(getattr(opt, leaf), getattr(osh, leaf))
        total += _tree_bytes(opt.count, osh.count)
        if state["err"] is not None:
            total += _tree_bytes(state["err"], sh["err"])
        return total
    params = model.abstract_params()
    total += _tree_bytes(params, shd.param_shardings(model.logical_axes(),
                                                     mesh))
    caches = steps_lib._abstract_caches(model, shape)
    if cfg.is_encdec and shape.kind == "decode":
        from repro_torch.models.whisper import WhisperCache
        caches = WhisperCache(caches, steps_lib._cross_abstract(model, shape))
    seq = plan.seq_shard_decode and shape.kind == "decode"
    total += _tree_bytes(caches, shd.cache_shardings(caches, mesh,
                                                     seq_shard=seq))
    return total


def _trace_step(model, shape, mesh, hyper):
    """Run one step of ``shape``'s kind on meta ``DTensor``s under
    ``analysis.Trace``."""
    cfg = model.cfg
    if shape.kind == "train":
        model.trainable()
        step = steps_lib.make_train_step(model, hyper, mesh)
        sh = steps_lib.train_state_shardings(model, mesh, hyper)
        state = steps_lib.shard_train_state(
            steps_lib.abstract_train_state(model, hyper), sh)
        state["params"] = dict(model.named_parameters())
        # the step count and the schedule's scalars stay on the host: the
        # schedule's cosine reads a table at a data-dependent index
        state["opt"] = state["opt"]._replace(
            count=torch.zeros((), dtype=torch.int32))
        batch = steps_lib.input_specs(cfg, shape)
        with analysis.Trace() as t:
            step(state, batch)
        return t
    if shape.kind == "prefill":
        fn, (_, batch, caches) = steps_lib.make_prefill_fn(model, mesh,
                                                           shape)
        with analysis.Trace() as t:
            fn(batch, caches)
        return t
    fn, _, _, caches = steps_lib.make_decode_fn(model, mesh, shape)
    toks = steps_lib.input_specs(cfg, shape)["tokens"]
    with analysis.Trace() as t:
        fn(caches, toks, 1024)
    return t


def lower_cell(arch: str, shape_name: str, mesh, *, plan_overrides=None,
               reduced: bool = False, shape=None, verbose: bool = True):
    """One (arch x shape) cell on ``mesh`` (a ``DeviceMesh`` of the current
    group, ``init_fake``'s for a production mesh): its plan, per-rank
    argument bytes, traced cost and collectives, and roofline at the
    H100's published peaks.  ``reduced`` takes the arch's reduced config,
    ``shape`` a ``ShapeConfig`` in place of ``shape_name``'s."""
    cfg = configs.get_reduced(arch) if reduced else configs.get(arch)
    shape = shape or configs.SHAPES[shape_name]
    if not configs.shape_applicable(cfg, shape):
        return {"skipped": True,
                "reason": "long_500k needs sub-quadratic attention"}
    n_dev = mesh.size()
    plan = steps_lib.make_plan(cfg, shape, mesh, overrides=plan_overrides)
    model = build_model(cfg, plan, device="meta")
    hyper = steps_lib.Hyper()
    args = argument_bytes(model, shape, mesh, hyper)
    t0 = time.time()
    with mesh_lib.set_mesh(mesh):
        t = _trace_step(model, shape, mesh, hyper)
    t_trace = time.time() - t0
    cost, coll = t.cost(), t.collectives()
    mf = analysis.model_flops_for(cfg, shape)
    roof = analysis.roofline(cost, coll, n_devices=n_dev, model_flops=mf)
    res = {
        "arch": arch, "shape": shape.name,
        "mesh": "x".join(map(str, mesh.shape)),
        "n_devices": n_dev,
        "trace_s": round(t_trace, 1),
        "memory": {"argument_size_in_bytes": args,
                   "total_bytes_per_device": args,
                   "temp_size_in_bytes_note": NO_TEMP},
        "cost": cost,
        "collectives": coll,
        "collectives_by_shape": analysis.by_shape(t.log),
        "roofline": roof,
        "plan": {"kv_quant": plan.kv_quant, "microbatches": plan.microbatches,
                 "seq_shard_decode": plan.seq_shard_decode,
                 "sp": plan.act_pspec is not None, "fsdp": plan.fsdp,
                 "tp": plan.tp, "dp": plan.dp, "pods": plan.pods},
    }
    if verbose:
        gb = args / 2**30
        print(f"  args/dev {gb:6.2f} GiB | flops/dev "
              f"{roof['hlo_flops_per_dev']:.3e} | coll/dev "
              f"{coll['total_bytes']:.3e} B | bottleneck "
              f"{roof['bottleneck']} | roofline_frac "
              f"{roof['roofline_frac']:.3f} | trace {t_trace:.1f}s",
              flush=True)
    return res


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else configs.list_archs()
    shapes = [args.shape] if args.shape else list(configs.SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    torch.set_num_threads(1)
    mesh_lib.init_fake(512 if any(meshes) else 256)

    failures = []
    for multi_pod in meshes:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device_type="cpu")
        mname = "2x16x16" if multi_pod else "16x16"
        for arch in archs:
            for shape in shapes:
                tag = f"{arch}__{shape}__{mname}"
                out = os.path.join(args.out, tag + ".json")
                if os.path.exists(out) and not args.force:
                    print(f"[dryrun] {tag}: cached")
                    continue
                print(f"[dryrun] {tag} ...", flush=True)
                try:
                    res = lower_cell(arch, shape, mesh)
                except Exception as e:
                    traceback.print_exc()
                    failures.append(tag)
                    res = {"error": str(e)[:2000], "arch": arch,
                           "shape": shape, "mesh": mname}
                with open(out, "w") as f:
                    json.dump(res, f, indent=1)
    if failures:
        print(f"[dryrun] FAILURES: {failures}")
        raise SystemExit(1)
    print("[dryrun] all cells passed")


if __name__ == "__main__":
    main()
