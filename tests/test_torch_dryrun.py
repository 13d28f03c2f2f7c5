"""The port's roofline analysis and dry run (``launch/analysis.py``,
``launch/dryrun.py``) against the JAX package's.

* ``model_flops_for`` and ``roofline`` (at the reference's v5e constants,
  197e12 / 819e9 / 50e9, with the reference's own ``scan_corrections``)
  equal the reference's for every config x shape, to the bit.
* ``analysis.Trace`` on the ``fake`` group (a subprocess): the collective
  bytes of a toy ``Partial -> Shard`` / ``Shard -> Replicate`` pair equal
  a hand count, the per-rank FLOPs of one GEMM on a (2, 2) mesh equal
  ``2 M N K`` over the ranks that split it, and one attention layer's
  prefill at S 4096 counts every query block against every key it reads,
  which is the count the reference's ``scan_corrections`` adds back.
* Two dry-run cells, each a subprocess under 60 s: a reduced Qwen1.5-0.5B
  on (2, 2) and Qwen1.5-0.5B ``train_4k`` on (16, 16) through the CLI.
  Their ``argument_size_in_bytes`` equals the bytes summed from the
  reference's shard shapes of the same leaves (train state and batch),
  and the CLI writes its JSON with the reference's keys where asked.
* DeepSeek-V2-Lite ``decode_32k`` on (2, 16, 16), a subprocess under
  40 s: the MoE keeps its experts' ffn dim split over "model", so a
  rank gathers at most 5e8 bytes and moves at most 1e9 in all, and the
  cell is not bound by its collectives (it was, at 2.977e10 gathered
  bytes, when every rank took the experts whole).

Run as a script (``--case``), the file is one of those subprocesses.
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
V5E = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)
CELLS = {"reduced-2x2": ("qwen1.5-0.5b", True, (2, 2), ("t", "train", 64, 8)),
         "qwen-16x16": ("qwen1.5-0.5b", False, (16, 16), None)}


def _run(args, env_extra=None, timeout=240):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", **(env_extra or {}))
    r = subprocess.run([sys.executable, *args], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-6000:]
    return r


# --------------------------------------------------------------------------
# Arithmetic
# --------------------------------------------------------------------------

def test_model_flops_and_roofline_match_reference():
    from repro import configs as jconfigs
    from repro.launch import analysis as jan
    from repro.models.plan import Plan as JPlan
    from repro_torch import configs
    from repro_torch.launch import analysis as tan
    cost = {"flops": 3.1e15, "bytes accessed": 7.7e12}
    coll = {"weighted_bytes": 5.5e10, "total_bytes": 4.1e10}
    n = 0
    for arch in configs.list_archs():
        for sname, shape in configs.SHAPES.items():
            jcfg, jshape = jconfigs.get(arch), jconfigs.SHAPES[sname]
            mf = tan.model_flops_for(configs.get(arch), shape)
            assert mf == jan.model_flops_for(jcfg, jshape), (arch, sname)
            corr = jan.scan_corrections(jcfg, jshape, JPlan(tp=16),
                                        n_devices=256)
            want = jan.roofline(cost, coll, n_devices=256, model_flops=mf,
                                corrections=corr)
            got = tan.roofline(cost, coll, n_devices=256, model_flops=mf,
                               corrections=corr, **V5E)
            assert got == want, (arch, sname)
            n += 1
    assert n == 40
    # the port's defaults are the H100's published peaks
    h = tan.roofline(cost, coll, n_devices=1, model_flops=1.0)
    assert h["compute_s"] == 3.1e15 / 989e12
    assert h["memory_s"] == 7.7e12 / 3.35e12
    assert h["collective_s"] == 5.5e10 / 450e9


# --------------------------------------------------------------------------
# Trace counts (a subprocess under the fake group)
# --------------------------------------------------------------------------

def _counts(out):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.launch import analysis
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.attention import prefill_mha
    mesh_lib.init_fake(4)
    mesh = mesh_lib.make_test_mesh(2, 2, device_type="cpu")
    res = {}
    # Partial -> Shard(0) over "data" (a reduce-scatter of 64 x 32 f32 into
    # 32 x 32 rows), then Shard(0) -> Replicate (an all-gather back to
    # 64 x 32)
    x = DTensor.from_local(torch.empty(64, 32, device="meta"), mesh,
                           (Partial(), Replicate()), run_check=False)

    def pair():
        y = x.redistribute(mesh, (Shard(0), Replicate()))
        y.redistribute(mesh, (Replicate(), Replicate()))
    res["coll"] = analysis.collective_bytes(pair)
    # one GEMM: (M, K) split over "data" by rows, (K, N) over "model" by
    # columns -> a local (M/2, K) @ (K, N/2)
    M, K, N = 512, 256, 384
    a = DTensor.from_local(torch.empty(M // 2, K, device="meta"), mesh,
                           (Shard(0), Replicate()), run_check=False)
    b = DTensor.from_local(torch.empty(K, N // 2, device="meta"), mesh,
                           (Replicate(), Shard(1)), run_check=False)
    with analysis.Trace() as t:
        a @ b
    res["gemm"] = t.flops
    # one attention layer's prefill, S 4096, heads split over "model"
    B, S, H, D = 2, 4096, 8, 64
    q = DTensor.from_local(torch.empty(B // 2, S, H // 2, D, device="meta",
                                       dtype=torch.bfloat16), mesh,
                           (Shard(0), Shard(2)), run_check=False)
    from torch.distributed.tensor.experimental import implicit_replication
    with analysis.Trace() as t, implicit_replication():
        prefill_mha(q, q, q, causal=True)
    res["attn"] = t.flops
    json.dump(res, open(out, "w"))


def test_by_shape_groups_the_log():
    """``analysis.by_shape`` groups ``Trace.log`` by kind and shapes, the
    most result bytes first, and keeps the ``top`` groups."""
    from repro_torch.launch.analysis import by_shape
    ag = {"kind": "all-gather", "in": [[2, 3]], "out": [[4, 3]],
          "bytes": 48, "group": "1"}
    ar = {"kind": "all-reduce", "in": [[5]], "out": [[5]], "bytes": 20,
          "group": "2"}
    big = dict(ar, bytes=400)
    log = [ag, ar, ag, ag, dict(ag, kind="all-to-all"), big]
    assert by_shape(log) == [
        ["all-reduce", [[5]], [[5]], 2, 420],
        ["all-gather", [[2, 3]], [[4, 3]], 3, 144],
        ["all-to-all", [[2, 3]], [[4, 3]], 1, 48]]
    assert by_shape(log, top=1) == by_shape(log)[:1]


def test_trace_counts_match_hand_counts(tmp_path):
    out = tmp_path / "counts.json"
    _run([os.path.abspath(__file__), "--case", "counts", str(out)])
    res = json.load(open(out))
    coll = res["coll"]
    assert coll["reduce-scatter"] == 32 * 32 * 4
    assert coll["all-gather"] == 64 * 32 * 4
    assert coll["count"] == 2 and coll["all-reduce"] == 0
    assert coll["total_bytes"] == 32 * 32 * 4 + 64 * 32 * 4
    assert coll["weighted_bytes"] == coll["total_bytes"]
    assert res["gemm"] == 2 * (512 // 2) * 256 * (384 // 2)
    # every 256-row query block against keys [0, q1): q k^T and p v
    B, S, H, D, bq = 1, 4096, 4, 64, 256
    hand = sum(2 * 2 * B * H * bq * q1 * D for q1 in range(bq, S + 1, bq))
    assert res["attn"] == hand
    assert res["attn"] > 2 * 2 * B * H * S * 1024 * D   # past one KV chunk


# --------------------------------------------------------------------------
# Dry-run cells
# --------------------------------------------------------------------------

_REF_BYTES = textwrap.dedent('''
    import json, math, sys
    import jax, numpy as np
    from repro import configs
    from repro.launch import sharding as shd, steps
    from repro.models import build_model
    arch, reduced, mshape, shape = json.loads(sys.argv[2])
    cfg = configs.get_reduced(arch) if reduced else configs.get(arch)
    shape = configs.ShapeConfig(*shape) if shape else \\
        configs.SHAPES["train_4k"]
    mesh = jax.make_mesh(tuple(mshape), ("data", "model"))
    plan = steps.make_plan(cfg, shape, mesh)
    model = build_model(cfg, plan)
    hyper = steps.Hyper()
    state = steps.abstract_train_state(model, hyper)
    sh = steps.train_state_shardings(model, mesh, hyper)
    batch = steps.input_specs(cfg, shape)
    bsh = shd.data_shardings(batch, mesh)
    def nbytes(a, s):
        return math.prod(s.shard_shape(a.shape)) * np.dtype(a.dtype).itemsize
    total = sum(jax.tree.leaves(jax.tree.map(nbytes, state, sh)))
    total += sum(jax.tree.leaves(jax.tree.map(nbytes, batch, bsh)))
    json.dump({"bytes": int(total)}, open(sys.argv[1], "w"))
''')


def _cell(out, name):
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    arch, reduced, mshape, shape = CELLS[name]
    if reduced:
        mesh_lib.init_fake(math.prod(mshape))
        mesh = mesh_lib.make_test_mesh(*mshape, device_type="cpu")
        res = dryrun.lower_cell(arch, None, mesh, reduced=True,
                                shape=configs.ShapeConfig(*shape))
        json.dump(res, open(out, "w"))
    else:
        outdir = os.path.dirname(out)
        dryrun.main(["--arch", arch, "--shape", "train_4k", "--out", outdir])
        os.replace(os.path.join(outdir, f"{arch}__train_4k__16x16.json"), out)


@pytest.mark.parametrize("name", list(CELLS))
def test_dryrun_cell_argument_bytes_match_reference(name, tmp_path):
    arch, reduced, mshape, shape = CELLS[name]
    ref = tmp_path / "ref.json"
    _run(["-c", _REF_BYTES, str(ref), json.dumps([arch, reduced, mshape,
                                                  shape])],
         {"XLA_FLAGS": f"--xla_force_host_platform_device_count="
                       f"{math.prod(mshape)}"})
    out = tmp_path / "cell.json"
    r = _run([os.path.abspath(__file__), "--case", name, str(out)],
             timeout=120)
    res = json.load(open(out))
    assert res["memory"]["argument_size_in_bytes"] == \
        json.load(open(ref))["bytes"]
    for key in ("arch", "shape", "mesh", "n_devices", "memory", "cost",
                "collectives", "roofline", "plan"):
        assert key in res, key
    assert res["n_devices"] == math.prod(mshape)
    assert res["cost"]["flops"] > 0 and res["collectives"]["count"] > 0
    roof = res["roofline"]
    assert roof["roofline_bound_s"] == max(
        roof["compute_s"], roof["memory_s"], roof["collective_s"])
    assert res["trace_s"] < 60, res["trace_s"]
    if not reduced:
        assert "[dryrun] all cells passed" in r.stdout
        assert res["plan"]["tp"] == 16 and res["plan"]["sp"]


def _moe_decode(out):
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.init_fake(512)
    mesh = mesh_lib.make_production_mesh(multi_pod=True, device_type="cpu")
    json.dump(dryrun.lower_cell("deepseek-v2-lite", "decode_32k", mesh),
              open(out, "w"))


def test_moe_decode_cell_keeps_experts_split(tmp_path):
    out = tmp_path / "cell.json"
    _run([os.path.abspath(__file__), "--case", "moe-decode", str(out)],
         timeout=120)
    res = json.load(open(out))
    coll = res["collectives"]
    assert res["mesh"] == "2x16x16" and res["plan"]["tp"] == 16
    assert coll["all-gather"] <= 5e8, coll
    assert coll["total_bytes"] <= 1e9, coll
    assert coll["all-to-all"] > 0, coll
    assert any(g[0] == "all-to-all" for g in res["collectives_by_shape"])
    assert res["roofline"]["bottleneck"] != "collective_s", res["roofline"]
    assert res["trace_s"] < 40, res["trace_s"]


if __name__ == "__main__":
    torch.set_num_threads(1)
    case, out = sys.argv[2], sys.argv[3]
    if case == "counts":
        _counts(out)
    elif case == "moe-decode":
        _moe_decode(out)
    else:
        _cell(out, case)
