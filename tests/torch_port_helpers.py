"""Shared set-up of the edtr_torch parity tests: the tiny flagship on both
sides, with every leaf of the JAX parameter tree drawn from a seeded numpy
generator (normal x 0.05, so zero-initialised convs carry signal) and
carried into the port through ``edtr_torch.utils.convert.pipeline_from_jax``."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__ as G
from edtr_torch.pipeline import build_flagship
from edtr_torch.utils.convert import pipeline_from_jax

IMAGE = 64  # tiny flagship input size; latents are IMAGE // 8
CTX = (77, 64)  # tiny text-embedding shape


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
