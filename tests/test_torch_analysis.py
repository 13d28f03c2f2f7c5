"""The port's simulation sanitizer (``repro_torch.analysis``) on the CPU.

Ported from ``tests/test_analysis.py``: for every lint rule and graph-audit
check that has a torch counterpart, one seeded violation the analyzer must
CATCH (lint fixtures are tmp files — Python, or CUDA for ``smem-budget``;
audit fixtures are real traced aten graphs) and one allowed form it must
leave alone; the launch contracts' violation gate and the budgets of every
registered contract on the CPU; zero findings on the shipped tree (the
lint over ``src/repro_torch``, the graph audit of every declared entry);
the JSON and SARIF reports; and the port's tables held against the JAX
package's: the carry-bound tables key for key and number for number, and
the rule catalog, where every JAX rule id is a port rule, a named rename or
a ``NOT_PORTED`` entry.
"""
import json
import textwrap
from typing import NamedTuple

import pytest

torch = pytest.importorskip("torch")

import repro.analysis as jax_analysis
from repro.analysis import jaxpr_audit
from repro_torch import analysis
from repro_torch.analysis import contracts, graph_audit, lint
from repro_torch.core import dram

CPU = "cpu"
META = torch.device("meta")

# ---------------------------------------------------------------------------
# lint rule fixtures


def _lint_rules_on(tmp_path, src: str, name: str = "fixture.py"):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    rep = lint.lint_paths([str(p)], repo_root=str(tmp_path))
    return [f.rule for f in rep.findings]


def test_lint_catches_traced_param_branch(tmp_path):
    rules = _lint_rules_on(tmp_path, """
        from repro_torch.core.timing import MechParams

        def make_step(static):
            def step(params: MechParams, carry, req):
                p = params
                if p.n_slots > 4:
                    return carry
                assert params.insert_threshold > 0
                return carry
            return step
        """)
    assert rules.count("traced-param-branch") == 2


def test_lint_allows_is_none_dispatch(tmp_path):
    rules = _lint_rules_on(tmp_path, """
        from repro_torch.core.timing import MechParams

        def make_step(static):
            def step(p: MechParams, carry, req):
                if p.n_slots is None:
                    return carry
                return carry
            return step
        """)
    assert "traced-param-branch" not in rules


def test_lint_catches_unmasked_padded_reduction(tmp_path):
    rules = _lint_rules_on(tmp_path, """
        import torch

        def pick_victim(fts):
            return torch.argmin(fts.benefit, dim=-1)

        def pick_row(fts):
            return fts.row_sum.min(dim=-1)
        """)
    assert rules.count("unmasked-padded-reduction") == 2


def test_lint_allows_masked_reduction(tmp_path):
    rules = _lint_rules_on(tmp_path, """
        import torch

        def pick_victim(fts, active):
            return torch.argmin(torch.where(active, fts.benefit, 1 << 30),
                                dim=-1)
        """)
    assert "unmasked-padded-reduction" not in rules


def test_lint_catches_host_reads_in_step(tmp_path):
    rules = _lint_rules_on(tmp_path, """
        import numpy as np

        def make_step(static):
            def step(carry, x):
                inc = np.int32(1)
                print(carry.item(), carry.tolist())
                return carry.cpu() + inc
            return step
        """)
    assert rules.count("numpy-in-scan-body") == 4


def test_lint_allows_host_reads_outside_step(tmp_path):
    rules = _lint_rules_on(tmp_path, """
        import numpy as np

        def finalize(counters):
            return np.asarray(counters.reads.cpu()), counters.t_end.item()
        """)
    assert "numpy-in-scan-body" not in rules


def test_lint_catches_kernel_load_in_call(tmp_path):
    rules = _lint_rules_on(tmp_path, """
        import ctypes

        def replay(path):
            return ctypes.CDLL(path).sim_replay_host
        """, name="kernels/sim_scan/sim_scan.py")
    assert rules == ["kernel-load-in-call"]


def test_lint_allows_kernel_load_in_build(tmp_path):
    rules = _lint_rules_on(tmp_path, """
        import ctypes

        def _open(path):
            return ctypes.CDLL(path)
        """, name="kernels/_build.py")
    assert rules == []


_CUDA_OVER = """
    constexpr int kRows = 256;
    constexpr int kCols = kRows * 2;
    __global__ void __launch_bounds__(128) big_kernel(float* out) {
      __shared__ alignas(16) float tile[kRows][kCols];
      __shared__ int flag;
      out[0] = tile[0][0] + flag;
    }
    constexpr int kDyn = 240 * 1024;
    __global__ void dyn_kernel(float* out) {
      extern __shared__ float buf[];
      out[0] = buf[0];
    }
    int launch(void) {
      return cudaFuncSetAttribute(
          dyn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDyn);
    }
"""


def test_lint_catches_smem_blowout(tmp_path):
    rules = _lint_rules_on(tmp_path, _CUDA_OVER, name="csrc/big.cu")
    assert rules == ["smem-budget", "smem-budget"]


def test_lint_skips_unresolvable_and_small_smem(tmp_path):
    rules = _lint_rules_on(tmp_path, """
        constexpr int kChunk = 16384;
        __global__ void ok_kernel(int n, float* out) {
          __shared__ alignas(128) unsigned char stage[2][kChunk];
          __shared__ float guess[MAX_ROWS * 1024];
          out[0] = stage[0][0];
        }
        int launch(int bytes) {
          return cudaFuncSetAttribute(
              ok_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        }
        """, name="csrc/ok.cu")
    assert rules == []


def test_lint_pragma_suppresses(tmp_path):
    rules = _lint_rules_on(tmp_path, """
        import ctypes

        def run(path):
            # repro: allow(kernel-load-in-call)
            return ctypes.CDLL(path)
        """)
    assert rules == []
    src = _CUDA_OVER.replace(
        "    __global__ void __launch_bounds__(128) big",
        "    // repro: allow(smem-budget)\n"
        "    __global__ void __launch_bounds__(128) big")
    assert _lint_rules_on(tmp_path, src, name="csrc/big.cu") == [
        "smem-budget"]


# ---------------------------------------------------------------------------
# graph-audit fixtures: seeded violations in real traced aten graphs


def _audit(fn, *args, carry_names=(), carry_bounds=None, lanes=1,
           step=True, functional=True):
    entry = graph_audit.Entry(
        "fixture", lambda: graph_audit.trace(fn, *args,
                                             functional=functional),
        carry_names=tuple(carry_names), carry_bounds=carry_bounds or {},
        lanes=lanes, step=step)
    return [f.rule for f in graph_audit.audit_entry(entry)]


def _meta(*shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype, device=META)


def test_audit_catches_float64_leak():
    assert "x64-leak" in _audit(lambda x: x.double() * 2.0,
                                _meta(4, dtype=torch.float32))


def test_audit_catches_int64_arithmetic():
    # int64 that is summed, not used as an index
    assert "x64-leak" in _audit(lambda x: (x.long() + 1).sum(), _meta(4))


def test_audit_allows_int64_indices():
    def fn(table, idx, score):
        lanes = torch.arange(idx.shape[0], device=idx.device)
        pos = torch.argmin(score, dim=-1).to(torch.int32)
        table[lanes, idx.long()] = pos
        return table, torch.ones_like(idx.long(), dtype=torch.int32)
    assert _audit(fn, _meta(4, 8), _meta(4), _meta(4, 8)) == []


class _Acc(NamedTuple):
    acc: torch.Tensor


def test_audit_catches_int32_accumulator_overflow():
    # +4096 a step for a 2**20-step declared capacity wraps int32
    assert "int32-overflow" in _audit(lambda a: (a + 4096,), _meta(4),
                                      carry_names=("acc",))


def test_audit_accepts_saturating_accumulator():
    cap = (1 << 30) - 1
    assert _audit(lambda a: ((a + 4096).clamp(max=cap),), _meta(4),
                  carry_names=("acc",)) == []
    assert _audit(lambda a: (torch.minimum(a + 4096, torch.full_like(
        a, cap)),), _meta(4), carry_names=("acc",)) == []


def test_audit_derives_index_put_increment():
    # x[i] += (flag) is a +1 read-modify-write: 2**20 steps fit
    def fn(a, i, flag):
        a[torch.arange(4, device=a.device), i.long()] += flag.to(torch.int32)
        return (a,)
    assert _audit(fn, _meta(4, 8), _meta(4), _meta(4, dtype=torch.bool),
                  carry_names=("acc",)) == []


def test_audit_catches_undeclared_accumulator():
    # the increment comes from an input: no derivable bound, no decl
    assert "undeclared-accumulator" in _audit(
        lambda a, x: (a + x,), _meta(4), _meta(4), carry_names=("acc",))


def test_audit_accepts_declared_step_bound():
    assert _audit(lambda a, x: (a + x,), _meta(4), _meta(4),
                  carry_names=("acc",), carry_bounds={
                      "acc": graph_audit.CarryBound("x < 64", step=64)}) == []


@pytest.mark.parametrize("fn", [
    lambda x: x + x.sum().item(),           # _local_scalar_dense
    lambda x: x.cpu() + 1,                  # a copy to the CPU
    lambda x: torch.nonzero(x),             # data-dependent shape
    lambda x: x[x > 0],                     # boolean-mask indexing
    lambda x: x + 1 if x.sum() > 0 else x,  # a Python branch: trace fails
], ids=["item", "cpu", "nonzero", "bool-mask", "branch"])
def test_audit_catches_host_sync(fn):
    assert "host-sync-in-step" in _audit(fn, _meta(4))


def test_audit_allows_device_select():
    # the branch as a select on the device, summed in int32 (a plain
    # ``x.sum()`` of int32 is int64 in torch: an x64 finding)
    assert _audit(lambda x: torch.where(x.sum(dtype=torch.int32) > 0, x + 1,
                                        x), _meta(4)) == []
    assert _audit(lambda x: torch.where(x.sum() > 0, x + 1, x),
                  _meta(4)) == ["x64-leak"]


def test_audit_catches_oversized_gather_in_step():
    n = 1 << 18
    perm = _meta(n)
    assert "oversized-gather" in _audit(lambda c, p: c[p.long()],
                                        _meta(n), perm)


def test_audit_allows_gather_within_per_lane_limit():
    # the same gather spread over 4 lanes is 2**16 elements a lane
    n = 1 << 18
    assert _audit(lambda c, p: c[p.long()], _meta(n), _meta(n),
                  lanes=4) == []


# ---------------------------------------------------------------------------
# launch-contract fixtures


def test_contract_violation_is_caught():
    bad = contracts.Contract("fixture.bad", "always over budget", 0, 0,
                             ("nothing",),
                             lambda dev: contracts.Observed(1, 1))
    contracts.REGISTRY["fixture.bad"] = bad
    try:
        fs = contracts.check_contract("fixture.bad", CPU)
        assert [f.rule for f in fs] == ["launch-contract"]
        assert "launch(es)" in fs[0].message and "build" in fs[0].message
        with pytest.raises(AssertionError, match="fixture.bad"):
            contracts.assert_launch_budget("fixture.bad",
                                           contracts.Observed(3, 0))
    finally:
        del contracts.REGISTRY["fixture.bad"]


def test_contract_crash_is_a_finding():
    def boom(dev):
        raise RuntimeError("grid broke")
    contracts.REGISTRY["fixture.crash"] = contracts.Contract(
        "fixture.crash", "crashes", 1, None, ("nothing",), boom)
    try:
        fs = contracts.check_contract("fixture.crash", CPU)
        assert [f.rule for f in fs] == ["launch-contract"]
        assert "grid broke" in fs[0].message
    finally:
        del contracts.REGISTRY["fixture.crash"]


# the budgets expected from the code, confirmed: (launches, builds) on CPU
EXPECTED = {
    "sweep.timings": (1, 0), "sweep.capacity": (1, 0),
    "sweep.segment": (1, 0), "sweep.warm-cache": (1, 0),
    "simulator.sweep_traces": (1, 0), "streaming.chunked-replay": (4, 0),
    "orchestrator.shard-sweep": (3, 0), "obs.telemetry-sweep": (4, 0),
    "obs.tail-latency": (4, 0), "workload.generate_many": (1, 0),
}


def test_registry_is_the_jax_registry():
    from repro.analysis import contracts as jc
    assert list(contracts.REGISTRY) == list(jc.REGISTRY) == list(EXPECTED)
    assert contracts.TIMINGS_GRID == jc.TIMINGS_GRID
    assert contracts.CAPACITY_GRID == jc.CAPACITY_GRID
    assert contracts.SEGMENT_GRID == jc.SEGMENT_GRID
    assert [c.max_builds for c in contracts.REGISTRY.values()].count(0) == 1


@pytest.mark.parametrize("name", list(EXPECTED))
def test_contract_holds_on_cpu(name):
    """Each grid's replays on the CPU are exactly the count the code
    implies (the generator contract: one structure, unless an earlier
    test of this process built it), within budget, and open no library."""
    got = {}
    assert contracts.check_contract(name, CPU, got) == []
    launches, builds = EXPECTED[name]
    if name == "workload.generate_many":
        assert got[name].launches <= launches
    else:
        assert got[name].launches == launches
    assert got[name].builds == builds
    c = contracts.REGISTRY[name]
    assert got[name].launches <= c.max_launches


def test_contract_replays_are_eager_on_cpu():
    n0 = dram.replay_count()
    contracts.check_contract("streaming.chunked-replay", CPU)
    assert dram.replay_count() - n0 == 4
    tags = list(dram.REPLAYS.last)[-4:]
    assert all(t.startswith("eager/fused/figcache_fast/")
                                  and t.endswith("/64x1") for t in tags)


# ---------------------------------------------------------------------------
# zero false positives on the shipped tree

def test_lint_clean_on_shipped_tree():
    rep = lint.lint_paths()
    assert rep.findings == [], "\n" + rep.render_text()
    assert len(rep.scanned) >= 40     # the walk actually found the tree
    assert any(p.endswith("csrc/figkv_tx.cu") for p in rep.scanned)


ENTRY_NAMES = [
    "dram.step[fused]", "dram.step[fused, 2 channels]",
    "dram.step[fused, 4 params x 2 channels]", "dram.step[dense]",
    "dram.step[telemetry, 4 params x 2 channels]",
    "orchestrator.shard_step[sharded]",
    "workload.generate[zipf_reuse, 1024]", "kernels.fts_lookup_ref",
    "kernels.reloc_ref", "kernels.figcache_decode_ref",
    "kernels.flash_attention_ref", "kernels.figkv_tx_ref",
]


@pytest.fixture(scope="module")
def entries():
    return {e.name: e for e in graph_audit.default_entries()}


def test_entry_list(entries):
    assert list(entries) == ENTRY_NAMES
    # every entry but the generator is held to every check
    assert [n for n, e in entries.items() if e.allow] == [
        "workload.generate[zipf_reuse, 1024]"]
    assert set(entries["workload.generate[zipf_reuse, 1024]"].allow) == {
        "x64-leak"}


@pytest.mark.parametrize("name", ENTRY_NAMES)
def test_graph_audit_clean_on_entry(entries, name):
    n0 = dram.replay_count()
    assert graph_audit.audit_entry(entries[name]) == []
    assert dram.replay_count() == n0   # tracing leaves the log as it was


def test_carry_names_cover_the_step(entries):
    """The step's carry leaves pair up by name, every int32 leaf of the
    simulator carry is derived or declared, and the telemetry carry adds
    the TelScan leaves."""
    sim = entries["dram.step[fused]"].carry_names
    assert {"open_row", "tags", "row_sum", "lat_sum_ns", "reads",
            "t_end"} <= set(sim)
    tel = entries["dram.step[telemetry, 4 params x 2 channels]"]
    assert set(tel.carry_names) - set(sim) == {
        "scalars", "bank_issues", "hist_win", "hist", "slo", "buf_scalars",
        "buf_banks", "buf_hist", "n"}
    assert set(entries["orchestrator.shard_step[sharded]"].carry_names) \
        - set(sim) == {"seg_done", "reqs_done"}


def test_generator_x64_is_real_but_allowed(entries):
    """The generator's wide values are there (the allowance is not
    vacuous) and it is still free of host syncs."""
    import dataclasses
    e = dataclasses.replace(entries["workload.generate[zipf_reuse, 1024]"],
                            allow={})
    rules = {f.rule for f in graph_audit.audit_entry(e)}
    assert rules == {"x64-leak"}


def test_audit_all_and_run_all_clean():
    rep = analysis.run_all(with_contracts=False)
    assert rep.findings == [], "\n" + rep.render_text()
    assert rep.passes == ["lint", "graph-audit"]


def test_cli_ci_on_cpu(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    js, sarif = tmp_path / "r.json", tmp_path / "r.sarif"
    assert main(["--ci", "--device", "cpu", "--json", str(js),
                 "--sarif", str(sarif)]) == 0
    out = json.loads(js.read_text())
    assert out["n_findings"] == 0 and out["meta"]["device"] == "cpu"
    assert out["passes"] == ["lint", "graph-audit", "launch-contracts"]
    assert "0 finding(s)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# reports, constants and tables


def test_sarif_and_json_render():
    rep = lint.lint_paths(("src/repro_torch/analysis",))
    rep.extend([analysis.Finding(rule="smem-budget", message="m",
                                 path="a.cu", line=3),
                analysis.Finding(rule="launch-contract", message="m",
                                 entry="sweep.capacity")])
    js = json.loads(rep.to_json())
    assert js["tool"] == "repro_torch.analysis" and js["n_errors"] == 2
    sarif = json.loads(rep.to_sarif(analysis.rule_index()))
    assert sarif["version"] == "2.1.0"
    run = sarif["runs"][0]
    assert len(run["tool"]["driver"]["rules"]) == len(analysis.rule_index())
    assert run["results"][0]["locations"][0]["physicalLocation"][
        "region"] == {"startLine": 3}
    assert run["results"][1]["locations"][0]["logicalLocations"][0][
        "name"] == "sweep.capacity"


def test_lat_sum_cap_headroom():
    """cap + per-step bound == INT32_MAX: the pre-clamp add can never
    wrap (the arithmetic fact the carry audit's clamp check relies on)."""
    assert dram.LAT_SUM_CAP + graph_audit.T_MAX == (1 << 31) - 1
    cap = torch.tensor(dram.LAT_SUM_CAP, dtype=torch.int32)
    below = cap - 5
    assert int((below + 4).clamp(max=dram.LAT_SUM_CAP)) == \
        dram.LAT_SUM_CAP - 1
    assert int((below + 4096).clamp(max=dram.LAT_SUM_CAP)) == \
        dram.LAT_SUM_CAP


@pytest.mark.parametrize("table", ["SIM_CARRY_BOUNDS", "ORCH_CARRY_BOUNDS",
                                   "HIST_CARRY_BOUNDS", "TEL_CARRY_BOUNDS"])
def test_bound_tables_equal_jax(table):
    ours, theirs = getattr(graph_audit, table), getattr(jaxpr_audit, table)
    assert list(ours) == list(theirs)
    for k in ours:
        assert (ours[k].abs_max, ours[k].step, ours[k].why) == \
            (theirs[k].abs_max, theirs[k].step, theirs[k].why), k


def test_constants_equal_jax():
    for name in ("INT32_MAX", "TRACE_LEN_BOUND", "T_MAX", "GATHER_LIMIT"):
        assert getattr(graph_audit, name) == getattr(jaxpr_audit, name)


def test_rule_catalog_covers_jax():
    """Every JAX rule is ported under its own id, ported under a named
    new id, or listed as not ported with a reason; nothing else."""
    ours, renamed, gone = (analysis.rule_index(), analysis.renamed(),
                           analysis.not_ported())
    jax_ids = set(jax_analysis.rule_index())
    assert renamed == {"launch-contract": "compile-contract",
                       "host-sync-in-step": "callback-in-scan",
                       "kernel-load-in-call": "jit-closure-cache",
                       "smem-budget": "pallas-vmem-budget"}
    assert set(gone) == {"weak-type-leak", "while-in-scan",
                         "pallas-io-alias"}
    assert all(len(why) > 40 for why in gone.values())
    mapped = {renamed.get(r, r) for r in ours}
    assert mapped | set(gone) == jax_ids
    assert not mapped & set(gone)


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to launch the sim_scan kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(EXPECTED))
def test_contract_holds_on_cuda(cuda_device, name):
    """On the card each replay of a contract's grid is one sim_scan
    launch: the kernel's own counter equals the replay count, within
    budget."""
    from repro_torch.kernels.sim_scan import sim_scan as scan
    got = {}
    before, r0 = scan.COUNTER.launches, dram.replay_count()
    assert contracts.check_contract(name, cuda_device, got) == []
    assert scan.COUNTER.launches - before == dram.replay_count() - r0
    if name != "workload.generate_many":
        assert got[name].launches == EXPECTED[name][0]


@pytest.mark.cuda
def test_dense_on_cuda_equals_sim_scan(cuda_device):
    """The dense body runs eagerly on the card and equals sim_scan's fused
    replay on every counter (a 320-request pressure trace, RowBenefit and
    Random)."""
    import numpy as np
    from repro_torch.core import timing
    idx = np.arange(320)
    tr = dram.Trace(t_issue=(idx * 16).astype(np.int32),
                    bank=(idx % 4).astype(np.int32),
                    row=((idx * 7) % 97).astype(np.int32),
                    col=((idx * 13) % 128).astype(np.int32),
                    is_write=idx % 5 == 0, core=(idx % 8).astype(np.int32))
    for policy in ("row_benefit", "random"):
        cfg = timing.paper_config("figcache_fast", cache_rows=2,
                                  policy=policy)
        p = cfg.params(device=cuda_device)
        fused = dram.simulate(tr, cfg.static, p, device=cuda_device)
        dense = dram.simulate(tr, cfg.static, p, variant="dense",
                              device=cuda_device)
        for a, b in zip(fused, dense):
            assert a.is_cuda and torch.equal(a, b)
