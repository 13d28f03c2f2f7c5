"""Test-suite bootstrap: degrade gracefully when ``hypothesis`` is absent.

Several test modules are hypothesis property tests.  CI images (and the
baked accelerator container) do not always ship ``hypothesis``, and a bare
``import hypothesis`` at module scope used to fail the whole collection —
taking every example-based test in the same file down with it.

When the real library is importable we do nothing.  Otherwise we install a
miniature deterministic shim into ``sys.modules`` *before* test modules are
imported: ``@given`` replays a small fixed set of examples drawn from the
declared strategies (so the properties still get exercised example-based),
and ``settings`` becomes a no-op decorator.  The shim intentionally supports
only the strategy combinators this suite uses — anything else raises, which
is the cue to either extend the shim or install the real dependency
(``pip install -r requirements-dev.txt``).
"""
from __future__ import annotations

import inspect
import random
import sys
import types

try:  # prefer the real library whenever available
    import hypothesis  # noqa: F401
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

# How many deterministic examples the shim replays per @given test.
_SHIM_EXAMPLES = 5


class _Strategy:
    """A deterministic example source standing in for a hypothesis strategy."""

    def __init__(self, name, sample):
        self._name = name
        self._sample = sample  # (random.Random) -> value

    def example(self, rng: random.Random):
        return self._sample(rng)

    def __repr__(self):
        return f"shim-strategy:{self._name}"


def _st_integers(min_value=-(2 ** 31), max_value=2 ** 31 - 1):
    def sample(rng):
        return rng.randint(min_value, max_value)
    return _Strategy(f"integers({min_value},{max_value})", sample)


def _st_floats(min_value=-1e9, max_value=1e9, **_kw):
    def sample(rng):
        return rng.uniform(min_value, max_value)
    return _Strategy(f"floats({min_value},{max_value})", sample)


def _st_booleans():
    return _Strategy("booleans", lambda rng: rng.random() < 0.5)


def _st_sampled_from(elements):
    elements = list(elements)

    def sample(rng):
        return elements[rng.randrange(len(elements))]
    return _Strategy(f"sampled_from({len(elements)})", sample)


def _st_lists(elements, min_size=0, max_size=10, **_kw):
    def sample(rng):
        n = rng.randint(min_size, max_size)
        return [elements.example(rng) for _ in range(n)]
    return _Strategy(f"lists[{min_size},{max_size}]", sample)


def _st_tuples(*strats):
    def sample(rng):
        return tuple(s.example(rng) for s in strats)
    return _Strategy("tuples", sample)


def _st_just(value):
    return _Strategy("just", lambda rng: value)


class _AssumeFailed(Exception):
    """Raised by the shim's ``assume`` — the current example is discarded."""


def _shim_assume(condition):
    if not condition:
        raise _AssumeFailed()
    return True


def _shim_given(*strategies, **kw_strategies):
    """Replay a fixed example set instead of hypothesis's search."""

    def decorate(fn):
        # like hypothesis, @given fills the *rightmost* positional params;
        # anything left over (fixtures) must stay visible to pytest, so the
        # wrapper impersonates the reduced signature
        sig = inspect.signature(fn)
        params = list(sig.parameters.values())
        split = len(params) - len(strategies)
        drawn_names = [p.name for p in params[split:]]
        remaining = [p for p in params[:split]
                     if p.name not in kw_strategies]

        def wrapper(*args, **kwargs):
            # one RNG per test function => deterministic, order-independent
            rng = random.Random(fn.__qualname__)
            for _ in range(_SHIM_EXAMPLES):
                drawn = {n: s.example(rng)
                         for n, s in zip(drawn_names, strategies)}
                named = {k: s.example(rng) for k, s in kw_strategies.items()}
                try:
                    fn(*args, **kwargs, **drawn, **named)
                except _AssumeFailed:
                    continue   # hypothesis semantics: discard the example

        wrapper.__name__ = fn.__name__
        wrapper.__qualname__ = fn.__qualname__
        wrapper.__doc__ = fn.__doc__
        wrapper.__signature__ = sig.replace(parameters=remaining)
        wrapper.hypothesis_shim = True
        return wrapper

    return decorate


def _shim_settings(*_a, **_kw):
    def decorate(fn):
        return fn
    return decorate


def _install_shim():
    mod = types.ModuleType("hypothesis")
    mod.__doc__ = "Deterministic example-based shim (tests/conftest.py)."
    mod.given = _shim_given
    mod.settings = _shim_settings
    mod.HealthCheck = types.SimpleNamespace(all=lambda: [])
    mod.assume = _shim_assume

    st = types.ModuleType("hypothesis.strategies")
    st.integers = _st_integers
    st.floats = _st_floats
    st.booleans = _st_booleans
    st.sampled_from = _st_sampled_from
    st.lists = _st_lists
    st.tuples = _st_tuples
    st.just = _st_just
    mod.strategies = st

    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = st


if not HAVE_HYPOTHESIS:
    _install_shim()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs a CUDA kernel of repro_torch on an NVIDIA GPU; "
        "skips (inside the test) where torch.cuda.is_available() is false")
