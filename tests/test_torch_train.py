"""Training on one device (``Model.loss``, ``launch.steps``,
``launch.train``) against the JAX package's ``jax.value_and_grad(
model.loss)`` and its optimizer, plus the ports of ``tests/test_system.py``'s
train-loop assertions.

The JAX model runs under ``jit`` with ``Plan(remat="full",
moe_capacity=1.25)``, as its trainer would (B 2, S 32, the reference's
``DataPipeline`` batch; its jitted *step* cannot run here without a mesh),
compiled at LLVM's lowest optimisation level (``_JIT``), which halves the
compile and moves no tolerance below.
Tolerances, and why:

* f32 parameters (both packages hold the converted weights in f32): loss
  within 1e-5 and every leaf's gradient within 1e-3 relative L2, every
  family; measured at most 4e-4 (the reduced Jamba's Mamba leaves), 3e-5
  elsewhere.  This is where the gradient's logic is held.
* bf16 parameters (the training dtype): loss within 2e-2, and each leaf's
  gradient within the family's ``BF16_GRAD_TOL`` relative L2, set from the
  reference's own spread: the JAX package's compiled and op-by-op
  gradients of the same loss differ by up to 0.04 (Qwen1.5), 0.15
  (Whisper) and 0.25 (DeepSeek-V2-Lite, whose routing flips); the port
  measured 0.04, 0.05 (Qwen2-VL), 0.06 (RWKV6), 0.14 and 0.27.  The
  reduced Jamba's bf16 forward is chaotic: its compiled and op-by-op JAX
  losses differ by 0.017 at S 32 and their gradients by 1.9, with every
  layer function bitwise equal to the port's alone; its bf16 loss is
  held at S 16 and its gradient only in f32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs
from repro.data import DataPipeline as JPipeline
from repro.models import Plan as JPlan
from repro.models import build_model as jbuild
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import cosine_schedule as j_cosine
from repro.optim.compress import ef_init as j_ef_init
from repro.optim.compress import ef_int8_compress as j_ef
from repro_torch import checkpoint as ckpt_lib
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.data import DataPipeline
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.launch import steps as steps_lib
from repro_torch.launch import train
from repro_torch.models import Plan, build_model
from repro_torch.models import layers as tlayers

FAMILIES = ["qwen1.5-0.5b", "deepseek-v2-lite", "qwen2-vl-72b",
            "whisper-tiny", "jamba-v0.1-52b", "rwkv6-3b"]
BF16_GRAD_TOL = {"qwen1.5-0.5b": 0.1, "qwen2-vl-72b": 0.1, "rwkv6-3b": 0.1,
                 "whisper-tiny": 0.2, "deepseek-v2-lite": 0.3,
                 "jamba-v0.1-52b": None}
BF16_SEQ = {"jamba-v0.1-52b": 16}
_JIT = dict(compiler_options={"xla_backend_optimization_level": 0,
                              "xla_llvm_disable_expensive_passes": True})



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tensors here are small: one intra-op thread runs them as fast
    and leaves the other cores to the test run's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _tbatch(nb):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in nb.items()}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@functools.lru_cache(maxsize=None)
def _jax_model(arch, seed=0):
    """The JAX model and its bf16 params (one init per family)."""
    jm = jbuild(jconfigs.get_reduced(arch),
                JPlan(remat="full", moe_capacity=1.25))
    return jm, jax.jit(jm.init_params, **_JIT)(jax.random.PRNGKey(seed))


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch):
    """The JAX model's jitted ``value_and_grad(loss)`` (one per family:
    jit caches each compile on its shapes and dtypes)."""
    jm = _jax_model(arch)[0]
    return jax.jit(jax.value_and_grad(jm.loss, has_aux=True), **_JIT)


def _jax_case(arch, dtype, S):
    """(params as numpy, batch, loss, metrics, grads as numpy) of the JAX
    model at B 2 on the reference pipeline's first batch."""
    jm, params = _jax_model(arch)
    params = jax.tree.map(lambda a: a.astype(dtype), params)
    nb = JPipeline(jm.cfg, jconfigs.ShapeConfig("t", "train", S, 2),
                   seed=0)._batch_for(0)
    (loss, aux), grads = _jax_value_and_grad(arch)(
        params, {k: jnp.asarray(v) for k, v in nb.items()})
    f32 = lambda t: jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                                 t)
    return (jax.tree.map(np.asarray, params), nb, float(loss),
            {k: float(v) for k, v in aux.items()}, f32(grads))


def _port_grads(arch, dtype, S):
    jparams, nb, jloss, jaux, jgrads = _jax_case(arch, dtype, S)
    cfg = tconfigs.get_reduced(arch)
    tm = build_model(cfg, Plan(remat="full", moe_capacity=1.25),
                     device="cpu")
    if dtype == jnp.float32:
        tm.float()
    tm.load_state_dict(convert.model_params_from_numpy(cfg, jparams,
                                                       device="cpu"))
    tm.trainable()
    loss, metrics = tm.loss(_tbatch(nb))
    loss.backward()
    want = convert.model_params_from_numpy(cfg, jgrads, device="cpu")
    return tm, loss.item(), metrics, jloss, jaux, want


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax_f32(arch):
    tm, loss, metrics, jloss, jaux, want = _port_grads(arch, jnp.float32, 32)
    assert abs(loss - jloss) < 1e-5, (loss, jloss)
    assert abs(metrics["aux"].item() - jaux["aux"]) < 1e-5
    for n, p in tm.named_parameters():
        g = _f32(p.grad)
        assert np.isfinite(g).all() and np.abs(g).max() > 0, n
        assert _rel(g, _f32(want[n])) < 1e-3, n


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax_bf16(arch):
    S = BF16_SEQ.get(arch, 32)
    tm, loss, metrics, jloss, _, want = _port_grads(arch, jnp.bfloat16, S)
    assert abs(loss - jloss) < 2e-2, (loss, jloss)
    tol = BF16_GRAD_TOL[arch]
    for n, p in tm.named_parameters():
        assert p.grad.dtype == p.dtype
        g = _f32(p.grad)
        assert np.isfinite(g).all() and np.abs(g).max() > 0, n
        if tol is not None:
            assert _rel(g, _f32(want[n])) < tol, n


def test_gelu_grad_matches_jax():
    """The GELU's gradient (tanh form) against ``jax.grad`` of
    ``jax.nn.gelu(approximate=True)``, op by op, on 4096 f32 inputs over
    [-6, 6]: within 2e-6 (one or two f32 roundings of the product rule).
    Without ``layers._Tanh`` the tanh term's gradient was lost (0.57 off
    on 8 randn inputs)."""
    x = np.random.default_rng(3).uniform(-6, 6, 4096).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jax.grad(
            lambda v: jax.nn.gelu(v, approximate=True).sum())(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_()
    tlayers.gelu_tanh(t).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("case", [
    ("float32", True, 0, 8, 2), ("float32", False, 0, 4, 4),
    ("bfloat16", True, 24, 8, 2), ("bfloat16", True, 0, 6, 3)],
    ids=["f32-causal-gqa", "f32-full", "bf16-window", "bf16-causal-gqa"])
def test_attention_function_grads_equal_autodiff(case):
    """``ops.MHA`` (the card's autograd route round the kernel) driven by
    the plain forward: its output is the plain version's bitwise, and its
    blockwise backward's q/k/v gradients equal autodiff of
    ``flash_attention_ref`` (f32 sums in another order: 1e-6 relative L2
    in f32, one bf16 rounding in bf16)."""
    dtype, causal, window, h, hkv = case
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn((2, 80, n, 16), generator=gen).to(dt)
               .requires_grad_() for n in (h, hkv, hkv))
    g = torch.randn((2, 80, h, 16), generator=gen).to(dt)
    out = ops.MHA.apply(q, k, v, causal, window, None, flash_attention_ref,
                        32)
    got = torch.autograd.grad(out, (q, k, v), g)
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    want = torch.autograd.grad(ref, (q, k, v), g)
    assert torch.equal(out, ref)
    tol = 1e-6 if dtype == "float32" else 8e-3
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert _rel(_f32(a), _f32(b)) < tol


# ---------------- the train step ----------------

def _small_shape(B=4, S=64):
    return tconfigs.ShapeConfig("train_small", "train", S, B)


def _trainer(arch, shape, hyper, seed, **overrides):
    cfg = tconfigs.get_reduced(arch)
    plan = steps_lib.make_plan(cfg, shape,
                               overrides={"microbatches": 1, **overrides})
    model = build_model(cfg, plan, device="cpu")
    state = steps_lib.init_train_state(
        model, torch.Generator().manual_seed(seed), hyper)
    return cfg, model, state, steps_lib.make_train_step(model, hyper)


def test_two_steps_match_jax_composed(monkeypatch):
    """Two port steps with error-feedback compression against a reference
    composed of the JAX package's ``value_and_grad(model.loss)``,
    ``ef_int8_compress``, ``cosine_schedule`` and ``adamw_update``, from
    the same f32 weights.  The first step's loss within 1e-5 and every
    gradient within 1e-3 relative L2 of ``value_and_grad``'s; then the
    port's gradients of each step go through the JAX composition (on dicts
    keyed by the port's names), and the port's learning rate equals it,
    its AdamW state (m, v, master, bf16 params) lies within 1e-6 of each
    leaf's largest value (the clip's global norm sums in another order)
    and its EF residuals within 1e-6 of the gradient's (the jitted
    reference contracts ``gf - q * s`` into one rounding).  Fed the reference's own gradients instead,
    the int8 quantum moves elements whose gradients differ in the fifth
    digit by a whole quantum, and the updates by up to 47 %."""
    arch = "qwen1.5-0.5b"
    hyper = steps_lib.Hyper(peak_lr=1e-3, warmup=1, total_steps=4,
                            grad_compress=True)
    cfg = tconfigs.get_reduced(arch)
    jm, jp = _jax_model(arch)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    model = build_model(cfg, steps_lib.make_plan(cfg, _small_shape(2, 32)),
                        device="cpu").float()
    model.load_state_dict(convert.model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp), device="cpu"))
    state = steps_lib.init_train_state(model, None, hyper)
    seen, real = [], steps_lib.ef_int8_compress

    def spy(g, err):
        seen.append({n: _f32(x) for n, x in g.items()})
        return real(g, err)

    monkeypatch.setattr(steps_lib, "ef_int8_compress", spy)
    step = steps_lib.make_train_step(model, hyper)

    @functools.partial(jax.jit, **_JIT)
    def jupdate(g, opt, err):
        g, err = j_ef(g, err)
        lr = j_cosine(opt.count, peak=hyper.peak_lr, warmup=hyper.warmup,
                      total=hyper.total_steps)
        p, opt = j_adamw_update(g, opt, lr=lr)
        return p, opt, err, lr

    named = {n: jnp.asarray(_f32(t)) for n, t in state["params"].items()}
    jopt, jerr = j_adamw_init(named), j_ef_init(named)
    pipe = JPipeline(jm.cfg, jconfigs.ShapeConfig("t", "train", 32, 2),
                     seed=0)
    for i in range(2):
        nb = next(pipe)
        state, metrics = step(state, _tbatch(nb))
        if i == 0:
            (jl, _), jg = _jax_value_and_grad(arch)(
                jp, {k: jnp.asarray(v) for k, v in nb.items()})
            assert abs(metrics["loss"].item() - float(jl)) < 1e-5
            jg = convert.model_params_from_numpy(
                cfg, jax.tree.map(np.asarray, jg), device="cpu")
            for n, g in seen[0].items():
                assert _rel(g, _f32(jg[n])) < 1e-3, n
        jparams, jopt, jerr, lr = jupdate(
            {n: jnp.asarray(g) for n, g in seen[i].items()}, jopt, jerr)
        assert metrics["lr"].item() == float(lr)
    assert int(state["opt"].count) == int(jopt.count) == 2
    opt = state["opt"]
    for n in named:
        g_scale = np.abs(seen[1][n]).max()
        for a, b, resid in ((state["err"], jerr, True),
                            (opt.m, jopt.m, False), (opt.v, jopt.v, False),
                            (opt.master, jopt.master, False),
                            (state["params"], jparams, False)):
            a, b = _f32(a[n]), _f32(b[n])
            # the residual is a rounding of the gradient: held at its scale
            scale = g_scale if resid else np.abs(b).max()
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * scale)


def _losses(arch, shape, hyper, n, seed=0, data_seed=0):
    cfg, _, state, step = _trainer(arch, shape, hyper, seed)
    pipe = DataPipeline(cfg, shape, seed=data_seed)
    losses = []
    for _ in range(n):
        state, metrics = step(state, _tbatch(next(pipe)))
        losses.append(metrics["loss"].item())
    return losses


def test_train_loss_decreases():
    hyper = steps_lib.Hyper(peak_lr=5e-3, warmup=5, total_steps=30)
    losses = _losses("qwen1.5-0.5b", _small_shape(), hyper, 30)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_grad_compress_converges():
    hyper = steps_lib.Hyper(peak_lr=5e-3, warmup=5, total_steps=25,
                            grad_compress=True)
    losses = _losses("qwen1.5-0.5b", _small_shape(B=4, S=32), hyper, 25)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


def test_checkpoint_restart_resumes_stream(tmp_path):
    """Four steps, a checkpoint with the data cursor, two more steps; a
    fresh model restored from the checkpoint takes the same two steps to
    bitwise the same parameters and optimizer state."""
    shape = _small_shape()
    hyper = steps_lib.Hyper(peak_lr=1e-3, warmup=2, total_steps=20)
    cfg, _, state, step = _trainer("qwen2-7b", shape, hyper, 1)
    pipe = DataPipeline(cfg, shape, seed=3)
    for _ in range(4):
        state, _ = step(state, _tbatch(next(pipe)))
    ckpt_lib.save_checkpoint(str(tmp_path), 3, state,
                             extra={"data_step": pipe.cursor.step})
    ref = state
    for _ in range(2):
        ref, _ = step(ref, _tbatch(next(pipe)))

    assert ckpt_lib.latest_step(str(tmp_path)) == 3
    _, _, fresh, step2 = _trainer("qwen2-7b", shape, hyper, 9)
    restored, extra = ckpt_lib.restore_checkpoint(str(tmp_path), 3, fresh)
    pipe2 = DataPipeline(cfg, shape, seed=3)
    pipe2.cursor.step = extra["data_step"]
    assert pipe2.cursor.step == 4
    for _ in range(2):
        restored, _ = step2(restored, _tbatch(next(pipe2)))
    for n, p in ref["params"].items():
        assert torch.equal(restored["params"][n], p), n
        assert torch.equal(restored["opt"].master[n], ref["opt"].master[n])
        assert torch.equal(restored["opt"].v[n], ref["opt"].v[n])


def test_microbatched_step_matches_single():
    """Gradient accumulation over 2 microbatches matches one batch
    numerically (same data, same init)."""
    shape = _small_shape(B=4, S=32)
    hyper = steps_lib.Hyper(peak_lr=1e-3, warmup=2, total_steps=10)
    out = {}
    for mb in (1, 2):
        cfg, _, state, step = _trainer("stablelm-12b", shape, hyper, 7,
                                       microbatches=mb)
        batch = _tbatch(next(DataPipeline(cfg, shape, seed=1)))
        state, metrics = step(state, batch)
        out[mb] = (metrics["loss"].item(), state["params"])
    assert abs(out[1][0] - out[2][0]) < 2e-2
    for n, p in out[1][1].items():
        np.testing.assert_allclose(_f32(p), _f32(out[2][1][n]), atol=3e-2)


def test_microbatch_split_cuts_positions3_on_dim1():
    batch = {"tokens": torch.arange(8).view(4, 2),
             "positions3": torch.arange(24).view(3, 4, 2),
             "scalar": torch.tensor(1.0)}
    parts = steps_lib.split_microbatches(batch, 2)
    assert torch.equal(parts[1]["tokens"], batch["tokens"][2:])
    assert torch.equal(parts[1]["positions3"], batch["positions3"][:, 2:])
    assert parts[0]["scalar"] is batch["scalar"]


def test_train_run_checkpoints_and_resumes(tmp_path):
    """``train.run`` on the CPU: 3 steps with a checkpoint at every step
    past the first, then a run to step 5 resumes from step 2 with the data
    cursor and reaches the losses of an uninterrupted 5-step run
    bitwise."""
    kw = dict(batch_override=2, seq_override=32, ckpt_every=1, log_every=1,
              device="cpu")
    first = train.run("qwen1.5-0.5b", "train_4k", steps=3,
                      ckpt_dir=str(tmp_path), **kw)
    assert first.start == 0 and len(first.step_s) == 3
    assert ckpt_lib.latest_step(str(tmp_path)) == 2
    resumed = train.run("qwen1.5-0.5b", "train_4k", steps=5,
                        ckpt_dir=str(tmp_path), **kw)
    whole = train.run("qwen1.5-0.5b", "train_4k", steps=5, **kw)
    assert resumed.start == 3
    assert resumed.losses == whole.losses[3:]
    assert first.losses == whole.losses[:3]
