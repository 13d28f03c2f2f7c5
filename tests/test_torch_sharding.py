"""The port's sharded LM stack (``launch/sharding.py``, ``launch/mesh.py``,
the mesh fields of ``models/plan.py``, the MoE's token groups and the
sharded steps of ``launch/steps.py``) against the JAX package.

* **Specs.** A subprocess with 512 forced host devices dumps the
  reference's param, FSDP, ZeRO-1, cache and batch ``PartitionSpec``s and
  shard shapes for every config on meshes (1,1), (2,2), (16,16) and
  (2,16,16); another, under the ``fake`` backend's 512-rank group, dumps
  the port's specs and each ``DTensor`` layout's local shape on the same
  meshes.  Every spec equals the reference's with its stacked layer entry
  removed, except ZeRO-1 / FSDP leaves where the reference split its
  layer axis: those are listed, and their per-device bytes are equal.
* **MoE groups.** ``moe_forward`` with ``dp * pods`` = 2 and 4 groups is
  bitwise the reference's (output, ``dropped_frac``, load-balance loss
  within 1e-6 relative) on the reduced DeepSeek-V2-Lite and Mixtral.
* **Gloo worlds.** (dp, tp) = (2, 1), (1, 2) and (2, 2) on the reduced
  Qwen1.5-0.5B and on the reduced DeepSeek-V2-Lite (4 experts,
  ``d_expert`` 48, one shared expert), one process a rank on the CPU:
  one sharded train step against the port's one-device step from the
  same f32 weights and batch (loss within 1e-6 relative, every gradient
  within 1e-5 relative L2, every updated f32 master within 1e-6 of its
  largest entry), a sharded prefill and 4 decode steps against the
  one-device ones in f32 (logits within 1e-4; the model tests' bound is
  2e-2), and each rank's local shapes against the reference's shard
  shapes.
* **Collectives.** Rank 0's collectives in those steps
  (``analysis.Trace.log``): no all-gather makes a routed expert weight
  whole or gathers its ffn slices over "model", and with the vocab
  split no collective moves the logits' gradient.

Run as a script, the file is one rank of a gloo world (``--worker``) or a
dump (``--port-dump``); the tests start those processes.
"""
import json
import math
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
MESHES = {"1x1": (1, 1), "2x2": (2, 2), "16x16": (16, 16),
          "2x16x16": (2, 16, 16)}
WORLDS = {"qwen-2x1": ("qwen1.5-0.5b", 2, 1),
          "qwen-1x2": ("qwen1.5-0.5b", 1, 2),
          "qwen-2x2": ("qwen1.5-0.5b", 2, 2),
          "deepseek-2x1": ("deepseek-v2-lite", 2, 1),
          "deepseek-1x2": ("deepseek-v2-lite", 1, 2),
          "deepseek-2x2": ("deepseek-v2-lite", 2, 2)}
SMALL = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}
TRAIN_B, TRAIN_S = 4, 32
SERVE_B, PROMPT, GEN = 4, 16, 4

_REF_DUMP = textwrap.dedent('''
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.launch import sharding as shd, steps
    from repro.models import build_model

    def spec(s):
        return [list(e) if isinstance(e, tuple) else e for e in tuple(s.spec)]

    def shard(s, shape):
        try:
            return list(s.shard_shape(tuple(shape)))
        except Exception:
            return None

    def rec(sh, ab):
        return {"spec": spec(sh), "shape": list(ab.shape),
                "dtype": str(ab.dtype), "shard": shard(sh, ab.shape)}

    def tmap(f, *trees):
        return jax.tree.map(f, *trees,
                            is_leaf=lambda x: isinstance(x, NamedSharding))

    def dump(cfg, mesh, names):
        out = {}
        plan = steps.make_plan(cfg, configs.SHAPES["train_4k"], mesh)
        model = build_model(cfg, plan)
        axes, ab = model.logical_axes(), model.abstract_params()
        p = shd.param_shardings(axes, mesh)
        f = shd.param_shardings(axes, mesh, fsdp=plan.fsdp, abstract_tree=ab)
        z = shd.zero1_shardings(axes, ab, mesh)
        out["params"] = tmap(lambda a, b, c, s: {"p": rec(a, s),
                             "f": rec(b, s), "z": rec(c, s)}, p, f, z, ab)
        out["fsdp"] = plan.fsdp
        dshape = configs.SHAPES["decode_32k"]
        dplan = steps.make_plan(cfg, dshape, mesh)
        dm = build_model(cfg, dplan)
        caches = jax.eval_shape(lambda: dm.init_decode(dshape.global_batch,
                                                       dshape.seq_len))
        if cfg.is_encdec:
            hkv = dplan.padded_kv_heads(cfg.n_kv_heads)
            cross = jax.ShapeDtypeStruct(
                (cfg.n_layers, dshape.global_batch, cfg.n_audio_frames, hkv,
                 cfg.hd), jnp.bfloat16)
            caches = (caches, (cross, cross))
        csh = shd.cache_shardings(caches, mesh)
        out["caches"] = tmap(lambda s, a: rec(s, a) if hasattr(a, "shape")
                             else {"spec": spec(s)}, csh, caches)
        out["batch"] = {}
        for sname in names:
            shape = configs.SHAPES[sname]
            b = steps.input_specs(cfg, shape)
            out["batch"][sname] = {k: rec(v, b[k]) for k, v in
                                   shd.data_shardings(b, mesh).items()}
        return out

    res = {}
    meshes = json.loads(sys.argv[2])
    for mname, shape in meshes.items():
        names = ("pod", "data", "model") if len(shape) == 3 else \\
            ("data", "model")
        mesh = jax.make_mesh(tuple(shape), names)
        res[mname] = {a: dump(configs.get(a), mesh,
                              ("train_4k", "prefill_32k", "decode_32k"))
                      for a in configs.list_archs()}
    small = json.loads(sys.argv[3])
    res["reduced"] = {}
    for mname, shape in small.items():
        mesh = jax.make_mesh(tuple(shape), ("data", "model"))
        res["reduced"][mname] = {
            a: dump(configs.get_reduced(a), mesh, ())
            for a in ("qwen1.5-0.5b", "deepseek-v2-lite")}
    json.dump(res, open(sys.argv[1], "w"))
''')


def _run(args, env_extra=None, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", **(env_extra or {}))
    r = subprocess.run([sys.executable, *args], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-6000:]
    return r


@pytest.fixture(scope="module")
def ref_dump(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.json"
    _run(["-c", _REF_DUMP, str(out), json.dumps(MESHES), json.dumps(SMALL)],
         {"XLA_FLAGS": "--xla_force_host_platform_device_count=512"})
    return json.load(open(out))


@pytest.fixture(scope="module")
def port_dump(tmp_path_factory):
    out = tmp_path_factory.mktemp("port") / "port.json"
    _run([os.path.abspath(__file__), "--port-dump", str(out)])
    return json.load(open(out))


# --------------------------------------------------------------------------
# The port's side of the dump (a subprocess under the fake group)
# --------------------------------------------------------------------------

def _tup(spec):
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


def _port_dump(path):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as shd, steps
    from repro_torch.models import build_model
    from repro_torch.models.whisper import WhisperCache
    mesh_lib.init_fake(512)

    def rec(sh, t):
        local = compute_local_shape_and_global_offset(
            tuple(t.shape), sh.mesh, sh.placements)[0]
        return {"spec": [list(e) if isinstance(e, tuple) else e
                         for e in sh.spec], "shape": list(t.shape),
                "local": list(local), "shard": list(sh.shard_shape(t.shape))}

    def walk(tree, shards):
        if isinstance(tree, torch.Tensor):
            return rec(shards, tree)
        if isinstance(tree, (list, tuple)):
            return [walk(a, s) for a, s in zip(tree, shards)]
        return None

    res = {}
    for mname, shape in MESHES.items():
        if len(shape) == 3:
            mesh = mesh_lib.make_production_mesh(multi_pod=True,
                                                 device_type="cpu")
        else:
            mesh = mesh_lib.make_test_mesh(*shape, device_type="cpu")
        res[mname] = {}
        for arch in configs.list_archs():
            cfg = configs.get(arch)
            plan = steps.make_plan(cfg, configs.SHAPES["train_4k"], mesh)
            model = build_model(cfg, plan, device="meta")
            sh = steps.train_state_shardings(model, mesh, steps.Hyper())
            ab = model.abstract_params()
            p = shd.param_shardings(model.logical_axes(), mesh)
            params = {n: {"p": rec(p[n], t), "f": rec(sh["params"][n], t),
                          "z": rec(sh["opt"].m[n], t)} for n, t in ab.items()}
            dshape = configs.SHAPES["decode_32k"]
            dm = build_model(cfg, steps.make_plan(cfg, dshape, mesh),
                             device="meta")
            caches = steps._abstract_caches(dm, dshape)
            if cfg.is_encdec:
                caches = WhisperCache(caches,
                                      steps._cross_abstract(dm, dshape))
            csh = shd.cache_shardings(caches, mesh)
            batch = {}
            for sname in ("train_4k", "prefill_32k", "decode_32k"):
                b = steps.input_specs(cfg, configs.SHAPES[sname])
                bsh = shd.data_shardings(b, mesh)
                batch[sname] = {k: rec(bsh[k], v) for k, v in b.items()}
            res[mname][arch] = {"params": params, "fsdp": plan.fsdp,
                                "caches": walk(caches, csh), "batch": batch}
    json.dump(res, open(path, "w"))


# --------------------------------------------------------------------------
# Spec comparison
# --------------------------------------------------------------------------

def _ref_by_name(cfg, tree):
    """{port parameter name: (reference leaf record, stacked)}: the
    reference's scan groups unstacked into the port's per-layer names."""
    from repro_torch import convert
    out = {}

    def flat(t, prefix):
        if isinstance(t, dict) and "p" not in t:
            for k, v in t.items():
                yield from flat(v, f"{prefix}{k}.")
        else:
            yield prefix[:-1], t
    if cfg.is_encdec:
        for part, n in (("enc", cfg.encoder_layers), ("dec", cfg.n_layers)):
            for path, leaf in flat(tree[part], ""):
                for i in range(n):
                    out[f"{part}.{i}.{path}"] = (leaf, True)
        for name in ("enc_ln", "dec_ln"):
            for path, leaf in flat(tree[name], ""):
                out[f"{name}.{path}"] = (leaf, False)
        for name in ("tok_embed", "pos_embed"):
            out[name] = (tree[name], False)
        return out
    out["tok_embed"] = (tree["tok_embed"], False)
    out["stack.ln_f"] = (tree["stack"]["ln_f"], False)
    if "lm_head" in tree:
        out["lm_head"] = (tree["lm_head"], False)
    for n, (layer, i, _) in enumerate(convert._layers(
            cfg, tree["stack"]["groups"])):
        for path, leaf in flat(layer, ""):
            out[f"stack.layers.{n}.{path}"] = (leaf, i is not None)
    return out


_ITEM = {"bfloat16": 2, "float32": 4, "int8": 1, "int32": 4}


def _dev_bytes(rec, count=1):
    return math.prod(rec["shard"]) * _ITEM[rec["dtype"]] / count


@pytest.mark.parametrize("mname", list(MESHES))
def test_param_and_zero1_specs_match_reference(mname, ref_dump, port_dump):
    """Param, FSDP and ZeRO-1 specs per leaf equal the reference's minus
    its layer entry, the port's local shard shapes equal the reference's
    shard shapes; where the reference split the stacked layer axis the
    leaf is listed and its per-device bytes are equal."""
    from repro_torch import configs
    from repro_torch.launch import sharding as shd
    divergent, whole, axes = [], [], {}

    def cfg_axes(arch, name):
        if arch not in axes:
            from repro_torch.models import build_model
            axes[arch] = build_model(configs.get(arch),
                                     device="meta").logical_axes()
        return axes[arch][name]
    for arch, port in port_dump[mname].items():
        cfg = configs.get(arch)
        ref = ref_dump[mname][arch]
        assert port["fsdp"] == ref["fsdp"], arch
        by_name = _ref_by_name(cfg, ref["params"])
        assert set(by_name) == set(port["params"]), arch
        counts = shd.stack_counts(cfg)
        for name, recs in port["params"].items():
            rleaf, stacked = by_name[name]
            count = next((c for p, c in counts.items()
                          if name.startswith(p)), 1) if stacked else 1
            for kind in ("p", "f", "z"):
                r, t = rleaf[kind], recs[kind]
                rspec = _tup(r["spec"])[1:] if stacked else _tup(r["spec"])
                assert t["shape"] == (r["shape"][1:] if stacked
                                      else r["shape"]), (arch, name)
                assert t["local"] == t["shard"], (arch, name, kind)
                if _tup(t["spec"]) == rspec:
                    want = r["shard"][1:] if stacked else r["shard"]
                    assert t["local"] == want, (arch, name, kind)
                    continue
                # the reference split the layer axis, the port a dim of
                # the layer's own leaf: the same bytes per device wherever
                # the leaf has a divisible dim
                assert stacked and kind in ("f", "z"), (arch, name, kind)
                assert _tup(r["spec"])[0] is not None, (arch, name, kind)
                assert _tup(r["spec"])[1:] == shd.param_pspec(
                    cfg_axes(arch, name)), (arch, name, kind)
                if t["local"] == t["shape"]:
                    whole.append((arch, name, kind))
                    continue
                port_bytes = math.prod(t["local"]) * _ITEM[r["dtype"]]
                assert port_bytes * count == _dev_bytes(r), (arch, name)
                divergent.append((arch, name, kind))
    # the layer axis is the reference's choice wherever a group's count
    # divides the data axes: at (1,1) every stacked group, at (2,2) the
    # even ones, at 16 x 16 Qwen2-VL-72B's 80 and RWKV6-3B's 32 layers
    assert all(kind in ("f", "z") for _, _, kind in divergent + whole)
    print(f"{mname}: {len(divergent)} leaves split on the layer axis by the "
          f"reference, per-device bytes equal; {len(whole)} whose layer "
          f"leaf has no divisible dim")


def _layer_caches(cfg, tree):
    """The reference's cache records per port layer (stacked or not)."""
    from repro_torch import convert
    if cfg.is_encdec:
        self_kv, (ck, cv) = tree
        layers = [(self_kv, True)] * cfg.n_layers
        return layers, (ck, cv)
    return [(c, i is not None) for c, i, _ in convert._layers(cfg, tree)], \
        None


@pytest.mark.parametrize("mname", list(MESHES))
def test_cache_and_batch_specs_match_reference(mname, ref_dump, port_dump):
    """Every KV / Mamba / RWKV cache leaf and Whisper's cross K/V: spec
    equal to the reference's minus its layer entry, local shape equal to
    its shard shape; every batch leaf of the three shape kinds equal."""
    from repro_torch import configs
    for arch, port in port_dump[mname].items():
        cfg = configs.get(arch)
        ref = ref_dump[mname][arch]
        for sname, leaves in port["batch"].items():
            for k, t in leaves.items():
                r = ref["batch"][sname][k]
                assert _tup(t["spec"]) == _tup(r["spec"]), (arch, sname, k)
                assert t["local"] == r["shard"], (arch, sname, k)
        layers, cross = _layer_caches(cfg, ref["caches"])
        pcaches = port["caches"]
        if cfg.is_encdec:
            pself, (pk, pv) = pcaches
            for rc, pc in zip((cross[0], cross[1]), (pk, pv)):
                for t in pc:
                    assert _tup(t["spec"]) == _tup(rc["spec"])[1:], arch
                    assert t["local"] == rc["shard"][1:], arch
        else:
            pself = pcaches
        assert len(pself) == cfg.n_layers
        for (rc, stacked), pc in zip(layers, pself):
            for r, t in zip(rc, pc):
                if t is None or r is None:     # length, or no scale
                    continue
                rspec = _tup(r["spec"])[1:] if stacked else _tup(r["spec"])
                assert _tup(t["spec"]) == rspec, (arch, t, r)
                want = r["shard"][1:] if stacked else r["shard"]
                assert t["local"] == want, (arch, t, r)


def test_spec_functions_port_the_reference_rules():
    """``test_infra.py``'s sharding rules on the port: param and ZeRO-1
    specs, batch specs on one and two pods, and ``placements``' order of
    a dim split over two axes."""
    from collections import namedtuple
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch import sharding as shd
    from repro_torch.spmd import placements
    Mesh = namedtuple("Mesh", "mesh_dim_names shape")
    one, pods = Mesh(("data", "model"), (16, 16)), \
        Mesh(("pod", "data", "model"), (2, 16, 16))
    assert shd.param_pspec(("embed", "q_heads", "head_dim")) == \
        (None, "model", None)
    assert shd.zero1_pspec(("embed", "ffn"), (4096, 1024), 16) == \
        ("data", "model")
    assert shd.zero1_pspec(("embed", "ffn"), (4096, 1024), 32) == \
        (("pod", "data"), "model")
    assert shd.zero1_pspec(("layers", "embed"), (3, 32), 16) == \
        (None, "data")
    assert shd.batch_pspec(one) == ("data", None)
    assert shd.batch_pspec(pods, seq_sharded=True) == \
        (("pod", "data"), "model")
    assert placements((("pod", "data"), "model"), pods) == \
        (Shard(0), Shard(0), Shard(1))
    assert placements((None, "model"), Mesh(("data", "model"), (4, 1))) == \
        (Replicate(), Replicate())


# --------------------------------------------------------------------------
# The MoE's token groups
# --------------------------------------------------------------------------

@pytest.mark.parametrize("groups", ["dp2", "dp2-pods2"])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite", "mixtral-8x22b"])
def test_moe_groups_match_reference(arch, groups):
    """``moe_forward`` with 2 and 4 token groups (capacity 1.25 per group)
    against the reference's vmapped groups: y and ``dropped_frac``
    bitwise, the load-balance loss within 1e-6 relative; drops are per
    group, so they differ from one group's."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import moe as jmoe
    from repro.models.plan import Plan as JPlan
    from repro_torch import configs as tconfigs
    from repro_torch.models import moe as tmoe
    from repro_torch.models.plan import Plan
    kw = {"dp2": dict(dp=2), "dp2-pods2": dict(dp=2, pods=2)}[groups]
    kw = dict(kw, moe_capacity=1.25)
    cfg, jcfg = tconfigs.get_reduced(arch), jconfigs.get_reduced(arch)
    rng = np.random.default_rng(7)
    jp, tp = {}, {}
    for name, spec in jmoe.moe_spec(jcfg, JPlan()).items():
        a = rng.normal(size=spec.shape) / np.sqrt(spec.shape[-2])
        jp[name] = jnp.asarray(a, spec.dtype)
        tp[name] = torch.from_numpy(np.array(
            jp[name].astype(jnp.float32))).to(
            torch.float32 if spec.dtype == jnp.float32 else torch.bfloat16)
    x = rng.normal(size=(4, 16, cfg.d_model))
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).bfloat16()
    with jax.disable_jit():
        jy, jaux = jmoe.moe_forward(jp, jx, jcfg, JPlan(**kw))
    ty, taux = tmoe.moe_forward(tp, tx, cfg, Plan(**kw))
    np.testing.assert_array_equal(
        ty.float().numpy(), np.asarray(jy.astype(jnp.float32)))
    assert float(taux["dropped_frac"]) == float(jaux["dropped_frac"])
    np.testing.assert_allclose(float(taux["load_balance_loss"]),
                               float(jaux["load_balance_loss"]), rtol=1e-6)
    one = tmoe.moe_forward(tp, tx, cfg, Plan(moe_capacity=1.25))[1]
    assert tmoe.n_groups(Plan(**kw), 4) == kw["dp"] * kw.get("pods", 1)
    assert float(one["dropped_frac"]) != float(taux["dropped_frac"]) or \
        float(taux["dropped_frac"]) == 0
    y_ref, _ = tmoe.moe_dense_ref(tp, tx, cfg, Plan(**kw))
    np.testing.assert_allclose(y_ref.float().numpy(), ty.float().numpy(),
                               atol=2e-2 + 2 ** -7, rtol=0)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 16])
def test_pair_plan_routes_gate_and_up(n):
    """``spmd.pair_plan`` simulated over all n ranks of one all-to-all:
    rank j ends with [gate_j | up_j] of a [gate | up] dim split in n equal
    parts, and the reverse all-to-all (the backward's) returns every
    rank's own blocks."""
    from repro_torch.spmd import pair_plan
    w = 3
    whole = np.concatenate([np.arange(n * w), 1000 + np.arange(n * w)])
    plans = [pair_plan(n, r) for r in range(n)]

    def all_to_all(inputs, sends, recvs):
        chunks = []
        for x, s in zip(inputs, sends):
            cut = np.cumsum([0] + s)
            chunks.append([x[a:b] for a, b in zip(cut[:-1], cut[1:])])
        out = []
        for j in range(n):
            got = [chunks[k][j] for k in range(n)]
            assert [len(g) for g in got] == recvs[j]
            out.append(np.concatenate(got))
        return out
    blocks = [whole[r * 2 * w:(r + 1) * 2 * w].reshape(2, w)
              for r in range(n)]
    sent = [b[::-1] if swap else b for b, (swap, _, _) in zip(blocks, plans)]
    got = all_to_all(sent, [p[1] for p in plans], [p[2] for p in plans])
    for j, g in enumerate(got):
        assert (g[0] == np.arange(j * w, (j + 1) * w)).all(), (n, j)
        assert (g[1] == 1000 + np.arange(j * w, (j + 1) * w)).all(), (n, j)
    back = all_to_all(got, [p[2] for p in plans], [p[1] for p in plans])
    for r, (b, (swap, _, _)) in enumerate(zip(back, plans)):
        assert (b[::-1] if swap else b).tolist() == blocks[r].tolist(), r


# --------------------------------------------------------------------------
# Gloo worlds
# --------------------------------------------------------------------------

def _worker(rank, world, dp, tp, port, arch, out):
    """One rank of a gloo world: the checks of ``test_gloo_world``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.launch.analysis import Trace
    from repro_torch.models import build_model
    from repro_torch.models.plan import Plan
    mesh = mesh_lib.make_test_mesh(dp, tp, device_type="cpu")
    assert mesh_lib.dp_axes(mesh) == ("data",)
    cfg = configs.get_reduced(arch)
    shape = configs.ShapeConfig("t", "train", TRAIN_S, TRAIN_B)
    hyper = steps.Hyper(peak_lr=1e-3, warmup=1, total_steps=4)
    res = {}

    def trainer(m):
        # the one-device plan keeps the mesh's groups: the same function
        plan = steps.make_plan(cfg, shape, m,
                               overrides={"microbatches": 1, "dp": dp})
        model = build_model(cfg, plan, device="cpu").float()
        return model, steps.init_train_state(
            model, torch.Generator().manual_seed(0), hyper)

    g = torch.Generator().manual_seed(5)
    batch = {k: torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                              generator=g) for k in ("tokens", "targets")}
    seen = []
    real = steps.adamw_update

    def spy(grads, opt, lr):
        seen.append({n: x.detach().clone() for n, x in grads.items()})
        return real(grads, opt, lr=lr)
    steps.adamw_update = spy
    m1, s1 = trainer(None)
    s1, met1 = steps.make_train_step(m1, hyper)(s1, batch)
    m2, s2 = trainer(mesh)
    assert m2.plan.tp == tp and m2.plan.dp == dp
    assert (m2.plan.hint_dp is not None) == (tp > 1)
    step = steps.make_train_step(m2, hyper, mesh)
    sh = steps.train_state_shardings(m2, mesh, hyper)
    s2 = steps.shard_train_state(s2, sh)
    res["local"] = {n: list(p.to_local().shape)
                    for n, p in m2.named_parameters()}
    res["zlocal"] = {n: list(x.to_local().shape)
                     for n, x in s2["opt"].m.items()}
    with Trace() as t:
        s2, met2 = step(s2, batch)
    res["coll"] = {"train": t.log}
    res["model_group"] = mesh.get_group("model").group_name
    masters = {n: steps.full(x) for n, x in s2["opt"].master.items()}
    params = {n: steps.full(x) for n, x in s2["params"].items()}
    g1, g2 = ({n: steps.full(x) for n, x in g.items()} for g in seen)
    res["loss"] = [met1["loss"].item(), met2["loss"].item()]
    res["grad_rel"] = max(float((g1[n] - g2[n]).norm() /
                                g1[n].norm().clamp(min=1e-30)) for n in g1)
    res["master_rel"] = max(float(
        (s1["opt"].master[n] - masters[n]).abs().max() /
        s1["opt"].master[n].abs().max().clamp(min=1e-30)) for n in g1)
    res["params_equal_model"] = all(
        torch.equal(params[n], steps.full(p))
        for n, p in m2.named_parameters())

    # serving: prefill + 4 greedy decode steps, f32 weights
    sshape = configs.ShapeConfig("s", "prefill", PROMPT + GEN + 8, SERVE_B)
    dshape = configs.ShapeConfig("d", "decode", PROMPT + GEN + 8, SERVE_B)
    ref = build_model(cfg, Plan(moe_capacity=0, dp=dp), device="cpu")
    ref.init_params(torch.Generator().manual_seed(3))
    ref.float()
    plan = steps.make_plan(cfg, sshape, mesh, overrides={"moe_capacity": 0})
    model = build_model(cfg, plan, device="cpu").float()
    model.load_state_dict(ref.state_dict())
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_B, PROMPT),
                           generator=torch.Generator().manual_seed(9))
    c1, l1 = ref.prefill({"tokens": prompt},
                         ref.init_decode(SERVE_B, sshape.seq_len))
    pre, _ = steps.make_prefill_fn(model, mesh, sshape)
    dec, _, c_sh, _ = steps.make_decode_fn(model, mesh, dshape)
    with Trace() as t:
        c2, l2 = pre({"tokens": prompt}, model.init_decode(SERVE_B,
                                                          sshape.seq_len))
    res["coll"]["prefill"] = t.log
    errs = [float((l1 - l2).abs().max())]
    tok = l1[:, -1].argmax(-1)[:, None]
    res["coll"]["decode"] = []
    for i in range(GEN):
        c1, l1 = ref.decode_step(c1, tok, PROMPT + i)
        with Trace() as t:
            c2, l2 = dec(c2, tok, PROMPT + i)
        res["coll"]["decode"] += t.log
        errs.append(float((l1 - l2).abs().max()))
        tok = l1[:, -1].argmax(-1)[:, None]
    res["serve_err"] = max(errs)
    res["cache_local"] = [list(c.k.to_local().shape) for c in c2]
    res["cache_spec"] = [list(list(e) if isinstance(e, tuple) else e
                              for e in s.k.spec) for s in c_sh]
    if rank == 0:
        json.dump(res, open(out, "w"))
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    """Every world of ``WORLDS`` at once, a process a rank -> {world: rank
    0's results, or the failed ranks' logs}."""
    base = tmp_path_factory.mktemp("gloo")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    runs = {}
    for world, (arch, dp, tp) in WORLDS.items():
        n, port, out = dp * tp, _free_port(), base / f"{world}.json"
        runs[world] = (out, [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(r),
             str(n), str(dp), str(tp), str(port), arch, str(out)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(n)])
    res = {}
    for world, (out, procs) in runs.items():
        logs = [p.communicate(timeout=300)[0] for p in procs]
        res[world] = json.load(open(out)) if all(
            p.returncode == 0 for p in procs) else "\n".join(
            log[-3000:] for log in logs)
    return res


@pytest.mark.parametrize("world", list(WORLDS))
def test_gloo_world(world, ref_dump, gloo_results):
    """One gloo world (a process a rank): the sharded train step, prefill
    and decode against the one-device port, and rank 0's local shapes
    against the reference's shard shapes (stated tolerances in the module
    docstring)."""
    arch, dp, tp = WORLDS[world]
    res = gloo_results[world]
    assert isinstance(res, dict), res
    l1, l2 = res["loss"]
    assert abs(l1 - l2) <= 1e-6 * abs(l1), res["loss"]
    assert res["grad_rel"] <= 1e-5, res["grad_rel"]
    assert res["master_rel"] <= 1e-6, res["master_rel"]
    assert res["params_equal_model"]
    assert res["serve_err"] <= 1e-4, res["serve_err"]

    from repro_torch import configs
    cfg = configs.get_reduced(arch)
    ref = ref_dump["reduced"][f"{dp}x{tp}"][arch]
    by_name = _ref_by_name(cfg, ref["params"])
    for name, local in res["local"].items():
        r, stacked = by_name[name]
        want = r["p"]["shard"][1:] if stacked else r["p"]["shard"]
        assert local == want, (name, local, want)
    for name, local in res["zlocal"].items():
        r, stacked = by_name[name]
        if stacked and _tup(r["z"]["spec"])[0] is not None:
            continue       # the reference split its layer axis
        want = r["z"]["shard"][1:] if stacked else r["z"]["shard"]
        assert local == want, (name, local, want)


def _gathered(rec):
    """The shapes an all-gather's result may stand for: its own, and its
    input's with one dim times the group's size (``DTensor`` gathers
    along dim 0, then moves the blocks to the gathered dim)."""
    src, out = rec["in"][0], rec["out"][0]
    n = out[0] // src[0] if src and src[0] else 1
    return [out] + [src[:i] + [src[i] * n] + src[i + 1:]
                    for i in range(len(src))]


@pytest.mark.parametrize("world", list(WORLDS))
def test_gloo_world_collectives(world, gloo_results):
    """The collectives rank 0 ran in its sharded train step, prefill
    and decode steps (``analysis.Trace.log``): no all-gather over "model"
    makes a routed expert weight whole, (E, d, 2f) or (E, f, d), or
    gathers its f-slices into a half (E, d, f) or (E, d, 2, f) (ZeRO's
    gathers of the updated shards over "data" are the reference's);
    with the vocab split over "model" no collective moves a
    (B, S, V / tp) logits gradient, of the global or the local batch."""
    from repro_torch import configs
    arch, dp, tp = WORLDS[world]
    res = gloo_results[world]
    assert isinstance(res, dict), res
    cfg = configs.get_reduced(arch)
    recs = [r for part in res["coll"].values() for r in part]
    if tp > 1:
        assert any(r["kind"] == "all-reduce" for r in res["coll"]["train"])
    if cfg.moe is not None:
        e, d = cfg.moe.n_experts, cfg.d_model
        f = -(-cfg.moe.d_expert // tp) * tp
        whole = [[e, d, 2 * f], [e, f, d], [e, d, f], [e, d, 2, f]]
        for r in recs:
            if r["kind"] == "all-gather" and r["group"] == \
                    res["model_group"]:
                assert not any(sh in whole for sh in _gathered(r)), r
        if tp > 1:
            assert any(r["kind"] == "all-to-all" for r in recs)
    if tp > 1:
        v = -(-cfg.vocab_size // max(256, tp)) * max(256, tp) // tp
        grad = [[TRAIN_B, TRAIN_S, v], [TRAIN_B // dp, TRAIN_S, v]]
        for r in res["coll"]["train"]:
            assert not any(sh in grad for sh in r["in"] + r["out"]), r


if __name__ == "__main__":
    if sys.argv[1] == "--worker":
        r, n, dp, tp, port = map(int, sys.argv[2:7])
        _worker(r, n, dp, tp, port, sys.argv[7], sys.argv[8])
    elif sys.argv[1] == "--port-dump":
        _port_dump(sys.argv[2])
