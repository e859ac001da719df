"""Shared test harness config.

XLA:CPU's in-process JIT accumulates live compiled executables for the
whole pytest run; past a few hundred programs the LLVM ORC runtime in
this sandbox's jaxlib segfaults inside `backend_compile` (observed
deterministically in full-suite runs, never in per-file runs — and on
unmodified trees, so it is an environment condition, not a repo bug).
Dropping the compilation caches at each module boundary keeps the live
set bounded at what one test file needs; cross-module cache reuse is
negligible because modules use disjoint shapes.
"""
import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def _bound_live_executables_per_module():
    yield
    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips where there is none)"
    )
