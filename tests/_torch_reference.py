"""Reaching the JAX reference package from the port's tests.

The reference imports ``jax.experimental.enable_x64``, which newer JAX
releases dropped (it lives on as ``jax.enable_x64``). The ``ref`` fixture
aliases the name only for the test module that uses it and undoes
everything on teardown: the alias goes, and so does every ``repro``
module imported under it, so the reference's own tests in the same
worker see the package exactly as they would without this module.
"""
import importlib
import sys
import types

import pytest

REF_MODULES = ("repro.core.channel", "repro.core.rngstream",
               "repro.core.ota", "repro.core.digital",
               "repro.core.ota_design", "repro.core.digital_design",
               "repro.core.baselines", "repro.core.bounds",
               "repro.core.sca", "repro.core.sca_jax",
               "repro.data.synthetic", "repro.data.partition",
               "repro.data.loader", "repro.kernels.ops", "repro.fl.tasks",
               "repro.fl.engine", "repro.fl.trainer", "repro.configs",
               "repro.models.common", "repro.models.layers",
               "repro.models.transformer", "repro.models.api",
               "repro.kernels.ref", "repro.core.collectives",
               "repro.launch.mesh", "repro.launch.steps", "repro.optim.sgd",
               "repro.optim.adam", "repro.optim.projection",
               "repro.checkpoint.ckpt", "repro.core.faults",
               "repro.core.async_fl", "repro.core.participation",
               "repro.api.results", "repro.api.spec", "repro.api.schemes",
               "repro.api.scenarios", "repro.api.plan",
               "repro.api.materialize", "repro.api.execute",
               "repro.api.cli", "repro.launch.shapes")


@pytest.fixture(scope="module")
def ref():
    """Namespace of reference modules, by last name (``ref.ota``, ...)."""
    import jax
    import jax.experimental

    before = set(sys.modules)
    aliased = not hasattr(jax.experimental, "enable_x64")
    if aliased:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        mods = {name.rsplit(".", 1)[1]: importlib.import_module(name)
                for name in REF_MODULES}
        yield types.SimpleNamespace(jax=jax, **mods)
    finally:
        if aliased:
            del jax.experimental.enable_x64
        for name in sorted(set(sys.modules) - before, reverse=True):
            if name == "repro" or name.startswith("repro."):
                del sys.modules[name]
                parent, _, child = name.rpartition(".")
                if parent in sys.modules:
                    sys.modules[parent].__dict__.pop(child, None)


@pytest.fixture(scope="module")
def one_thread():
    """torch on one intra-op thread for a module of tiny tensors, restored
    after. When the suite's workers oversubscribe the cores, threads that
    wait for each other at every op stall: a 4-client train step of
    scaled-down whisper-tiny took 71 s on 8 threads and 1.3 s on one,
    beside 7 busy processes on 8 cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

