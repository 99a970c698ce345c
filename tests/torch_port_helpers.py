"""Shared set-up of the edtr_torch parity tests: the tiny flagship on both
sides, with every leaf of the JAX parameter tree drawn from a seeded numpy
generator (normal x 0.05, so zero-initialised convs carry signal) and
carried into the port through ``edtr_torch.utils.convert.pipeline_from_jax``."""

from __future__ import annotations

import functools
from concurrent.futures import Future, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__ as G
from edtr_torch.pipeline import build_flagship
from edtr_torch.utils.convert import pipeline_from_jax

IMAGE = 64  # tiny flagship input size; latents are IMAGE // 8
CTX = (77, 64)  # tiny text-embedding shape


# XLA's cheap optimisation level for the JAX steps the tests compare against
# (what ``jax_disable_most_optimizations`` sets, per compile): the step,
# detector-step and recipe tests take 7.4 CPU minutes in place of 11.7 and
# pass at their limits (it moved the generic step's losses by ~3e-7
# relative). The generic step's unoptimised run costs more than its compile
# saves (18.7 against 14.6 CPU minutes), so its test keeps XLA's default.
STEP_COMPILE_OPTIONS = {"xla_backend_optimization_level": 0,
                        "xla_llvm_disable_expensive_passes": True}
# the generic step (a whole ResNet-18 or DeepLabV3 beside the tiny flagship)
# runs too long unoptimised: level 0 took it to 61.7 s of compile and 350.7
# of run CPU (seg, accum 2), XLA's default level 150.0 and 19.0, level 1
# 123.4 and 23.3 (cls, accum 1: 81.1 + 3.6 against 68.4 + 3.2); losses 1e-7
# relative apart
GENERIC_COMPILE_OPTIONS = {"xla_backend_optimization_level": 1}


def compiled_step(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with :data:`STEP_COMPILE_OPTIONS`."""
    return jax.jit(fn).lower(*args).compile(STEP_COMPILE_OPTIONS)


@functools.lru_cache(maxsize=1)
def _pool() -> ThreadPoolExecutor:
    return ThreadPoolExecutor(4)


def compiled_in_thread(fn, *args, post=lambda out: out,
                       options=STEP_COMPILE_OPTIONS) -> Future:
    """``post(jax.jit(fn)(*args))`` as a future: traced here (tracing holds
    the interpreter lock), compiled with ``options`` and run in a worker
    thread, so the XLA compiles of a module's JAX references overlap one
    another and the tracing of the next."""
    lowered = jax.jit(fn).lower(*args)
    return _pool().submit(lambda: post(lowered.compile(options)(*args)))


def random_tree(shapes, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * 0.05).astype(np.float32), shapes)


@functools.lru_cache(maxsize=1)
def jax_tiny():
    """(JAX tiny pipeline, random params tree of numpy arrays)."""
    pipe = G._flagship_pipeline(dtype=None, tiny=True)

    def init(key):
        ks = jax.random.split(key, 2)
        p = pipe.cldm.init_params(ks[0], latent_hw=IMAGE // 8)
        p["swinir"] = pipe.swinir.init(ks[1], jnp.zeros((1, IMAGE, IMAGE, 3)))["params"]
        return p

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return pipe, random_tree(shapes, seed=5)


def load_port(pipe_t, params) -> None:
    """Load the JAX tree into a port pipeline, strictly."""
    pipe_t.load_state_dict(pipeline_from_jax(params), strict=True)


@functools.lru_cache(maxsize=1)
def port_tiny():
    """The port's tiny fp32 pipeline on the CPU, with the JAX tree loaded."""
    _, params = jax_tiny()
    pipe_t = build_flagship(tiny=True, dtype=None, device="cpu")
    load_port(pipe_t, params)
    return pipe_t.eval()


def t2n(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().numpy()


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return t2n(x).transpose(0, 2, 3, 1)


@functools.lru_cache(maxsize=1)
def stock_restore():
    """(args, outputs as numpy) of the port's tiny restore in the stock
    configuration (``fused_conv``, ``fused_proj`` and ``fused_swin`` off:
    stock PyTorch modules) on the inputs and replayed noise of
    ``tests/test_torch_pipeline.py::test_tiny_restore_matches_jax``, which
    holds it to JAX's restore (pre_restored 2e-3, z 5e-3, restored 1e-2):
    the reference of the other configurations' tiny restores."""
    from test_torch_pipeline import RESTORE_KEY, _replay_noise, restore_inputs

    _, params = jax_tiny()
    pipe = build_flagship(tiny=True, dtype=None, device="cpu", fused_conv=False,
                          fused_proj=False, fused_swin=False)
    load_port(pipe, params)
    lq, c_txt = restore_inputs()
    hw = IMAGE // 8
    noise, step_noise = _replay_noise(jax.random.PRNGKey(RESTORE_KEY), (1, hw, hw, 4), 4)
    args = tuple(torch.from_numpy(a) for a in (lq, c_txt, noise, step_noise))
    with torch.no_grad():
        out = pipe.eval().restore(*args)
    return args, {k: t2n(v) for k, v in out.items()}
