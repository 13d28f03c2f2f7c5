"""The port's Mixture-of-Experts FFN (``repro_torch.models.moe``) against
the JAX package's ``repro.models.moe`` and against its own plain
reference ``moe_dense_ref``.

The same numpy inputs, made from a seed, go through both packages: the
layer input x (B, S, D) and the parameters (router f32, experts and
shared experts bf16), at the reduced Mixtral (no shared experts), the
reduced DeepSeek-V2-Lite (one shared expert of 48) and the reduced Jamba
(MoE on every second layer), under capacity factor 0 (drop-free), 1.25
and 0.5 (drops happen), all tokens in one group as the reference
dispatches them on one device.  The JAX side runs eagerly
(``jax.disable_jit()``), as ``test_torch_models.py``.

Routing (``idx``, ``keep``, ``slot``) is held equal to the reference's
(its sort, ``searchsorted`` and capacity steps, ``moe.py:46-59``, run on
the JAX arrays), ``dropped_frac`` exactly equal, ``load_balance_loss``
within 1e-6 relative, and y within bf16 2e-2.  On the CPU these tests
were written on, y was bitwise equal to the JAX package's in every case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models.plan import Plan as JPlan
from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe
from repro_torch.models.plan import Plan

ARCHS = ["mixtral-8x22b", "deepseek-v2-lite", "jamba-v0.1-52b"]
PLANS = {"dropfree": dict(moe_capacity=0), "cap1.25": dict(moe_capacity=1.25),
         "cap0.5": dict(moe_capacity=0.5)}
B, S = 4, 16


def _bf(a, dtype=jnp.bfloat16):
    """numpy -> the same values as a JAX array and a torch tensor."""
    j = jnp.asarray(a, dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _params(cfg, seed, router=None):
    """The MoE leaves of ``cfg`` from numpy: normal draws times
    1/sqrt(fan_in), the router f32, the rest bf16 -> (JAX dict, torch
    dict)."""
    rng = np.random.default_rng(seed)
    jp, tp = {}, {}
    for name, spec in jmoe.moe_spec(cfg, JPlan()).items():
        a = rng.normal(size=spec.shape) / np.sqrt(spec.shape[-2])
        if name == "router" and router is not None:
            a = router
        jp[name], tp[name] = _bf(a, spec.dtype)
    return jp, tp


def _x(cfg, seed, b=B, s=S):
    return _bf(np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)))


def _jax_routing(logits, cfg, C):
    """The reference's routing of one group (``moe.py:46-59`` on JAX
    arrays), moved back to the (token, choice) layout."""
    m = cfg.moe
    _, idx = jmoe.route_topk(logits, m.top_k)
    tk = idx.size
    flat_e = idx.reshape(tk)
    order = jnp.argsort(flat_e)
    e_sorted = flat_e[order]
    starts = jnp.searchsorted(e_sorted, jnp.arange(m.n_experts))
    rank = jnp.arange(tk) - starts[e_sorted]
    keep = rank < C
    slot = e_sorted * C + jnp.where(keep, rank, 0)
    keep_tk = jnp.zeros(tk, bool).at[order].set(keep)
    slot_tk = jnp.zeros(tk, jnp.int32).at[order].set(slot)
    return (np.asarray(idx), np.asarray(keep_tk).reshape(idx.shape),
            np.asarray(slot_tk).reshape(idx.shape))


def _run_both(arch, plan, seed=0, router=None, x=None):
    cfg = tconfigs.get_reduced(arch)
    jcfg = jconfigs.get_reduced(arch)
    jp, tp = _params(jcfg, seed, router)
    jx, tx = x if x is not None else _x(cfg, seed + 1)
    with jax.disable_jit():
        jy, jaux = jmoe.moe_forward(jp, jx, jcfg, JPlan(**plan))
    ty, taux, route = tmoe.moe_forward(tp, tx, cfg, Plan(**plan),
                                       routing=True)
    return cfg, (jp, jx, jy, jaux), (tp, tx, ty, taux, route)


def _assert_routing_equal(jx, jp, cfg, plan, r):
    C = tmoe.capacity(cfg, Plan(**plan), *jx.shape[:2])
    logits = jx.reshape(-1, jx.shape[-1]).astype(jnp.float32) @ jp["router"]
    idx, keep, slot = _jax_routing(logits, cfg, C)
    np.testing.assert_array_equal(r.idx.numpy(), idx, "idx")
    np.testing.assert_array_equal(r.keep.numpy(), keep, "keep")
    np.testing.assert_array_equal(r.slot.numpy(), slot, "slot")


@pytest.mark.parametrize("plan", list(PLANS), ids=list(PLANS))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_jax(arch, plan):
    """Routing and dropped share exactly, y within bf16 2e-2 (bitwise on
    the CPU they were written on), the load-balance loss within 1e-6
    relative."""
    plan = PLANS[plan]
    cfg, (jp, jx, jy, jaux), (_, _, ty, taux, route) = _run_both(arch, plan)
    assert ty.shape == (B, S, cfg.d_model) and ty.dtype == torch.bfloat16
    _assert_routing_equal(jx, jp, cfg, plan, route)
    assert float(taux["dropped_frac"]) == float(jaux["dropped_frac"])
    if plan["moe_capacity"] == 0.5:
        assert float(taux["dropped_frac"]) > 0      # drops happen
    elif plan["moe_capacity"] == 0:
        assert float(taux["dropped_frac"]) == 0
    np.testing.assert_allclose(float(taux["load_balance_loss"]),
                               float(jaux["load_balance_loss"]), rtol=1e-6)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=2e-2, rtol=0)


@pytest.mark.parametrize("plan", list(PLANS), ids=list(PLANS))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_dense_ref(arch, plan):
    """The sort-based dispatch against the expert-by-expert reference:
    the same routing (idx, keep, slot), y within 2e-2 plus one bf16 ulp
    (the dispatch rounds each weighted row and each add to bf16, the
    reference sums in f32 and rounds once)."""
    plan = PLANS[plan]
    cfg = tconfigs.get_reduced(arch)
    _, tp = _params(jconfigs.get_reduced(arch), 3)
    _, tx = _x(cfg, 4)
    y, _, r = tmoe.moe_forward(tp, tx, cfg, Plan(**plan), routing=True)
    want, q = tmoe.moe_dense_ref(tp, tx, cfg, Plan(**plan))
    for name in ("idx", "keep", "slot"):
        assert torch.equal(getattr(r, name), getattr(q, name)), name
    excess = (y.float() - want.float()).abs() - want.float().abs() * 2 ** -7
    assert float(excess.max()) <= 2e-2


def test_capacity_follows_the_reference():
    """``moe.py:91-98`` with one token group: drop-free up to 8192
    assignments, then twice the mean load; otherwise the factor."""
    ds = tconfigs.get("deepseek-v2-lite")
    assert tmoe.capacity(ds, Plan(moe_capacity=0), 4, 4096) == 3072
    assert tmoe.capacity(ds, Plan(moe_capacity=0), 4, 1) == 24
    assert tmoe.capacity(ds, Plan(moe_capacity=0), 2, 682) == 8184
    mx = tconfigs.get("mixtral-8x22b")
    assert tmoe.capacity(mx, Plan(moe_capacity=0), 2, 4096) == 4096
    assert tmoe.capacity(mx, Plan(), 4, 16) == 20
    assert tmoe.capacity(mx, Plan(moe_capacity=0.5), 4, 16) == 8


def test_drops_keep_the_earliest_tokens():
    """Capacity 0.5 with most tokens routed to expert 0: the kept ones are
    its earliest tokens in token order (the stable sort).  An unstable
    sort would keep others: expert 0 has more assignments than its
    capacity, so which tokens it keeps is a choice, and the port and the
    JAX package make the same one."""
    cfg = tconfigs.get_reduced("mixtral-8x22b")
    router = np.random.default_rng(7).normal(size=(cfg.d_model, 4)) * 0.01
    router[:, 0] += 0.5                                # expert 0 is popular
    jx, tx = _bf(np.abs(np.random.default_rng(8).normal(
        size=(B, S, cfg.d_model))))
    plan = PLANS["cap0.5"]
    _, (jp, _, jy, jaux), (_, _, ty, taux, r) = _run_both(
        "mixtral-8x22b", plan, router=router, x=(jx, tx))
    C = tmoe.capacity(cfg, Plan(**plan), B, S)
    tokens0 = (r.idx == 0).any(dim=1).nonzero()[:, 0]
    assert tokens0.numel() > C                         # a choice is made
    kept0 = (r.keep & (r.idx == 0)).any(dim=1).nonzero()[:, 0]
    assert torch.equal(kept0, tokens0[:C])
    _assert_routing_equal(jx, jp, cfg, plan, r)
    assert float(taux["dropped_frac"]) == float(jaux["dropped_frac"]) > 0
    np.testing.assert_allclose(_np(ty), _np(jy), atol=2e-2, rtol=0)


def test_tied_router_logits_pick_the_lower_expert():
    """Experts 1 and 2 (and 0 and 3) have identical router columns, so
    every token's two largest logits tie exactly; ``lax.top_k`` takes the
    lower expert id first, and so does the port (``torch.topk`` promises no
    order among ties)."""
    cfg = tconfigs.get_reduced("mixtral-8x22b")
    col = np.random.default_rng(9).normal(size=(cfg.d_model, 2)) * 0.2
    router = np.stack([col[:, 0], col[:, 1], col[:, 1], col[:, 0]], 1)
    plan = PLANS["dropfree"]
    _, (jp, jx, jy, _), (tp, tx, ty, _, r) = _run_both(
        "mixtral-8x22b", plan, router=router)
    assert set(map(tuple, r.idx.tolist())) <= {(0, 3), (1, 2)}  # lower first
    _assert_routing_equal(jx, jp, cfg, plan, r)
    w, _ = tmoe.route_topk(tx.reshape(-1, cfg.d_model).float() @ tp["router"],
                           2)
    assert bool((w == 0.5).all())
    np.testing.assert_allclose(_np(ty), _np(jy), atol=2e-2, rtol=0)


def test_route_topk_matches_jax():
    """Top-k order and the softmax over the k values (not over all
    experts), at DeepSeek-V2-Lite's 64 experts, top 6."""
    logits = np.random.default_rng(10).normal(size=(256, 64)).astype(
        np.float32)
    jw, jidx = jmoe.route_topk(jnp.asarray(logits), 6)
    tw, tidx = tmoe.route_topk(torch.from_numpy(logits), 6)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, rtol=1e-6)

