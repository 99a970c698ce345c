"""The port's CLIP text path (``edtr_torch.data.tokenizer``,
``edtr_torch.models.clip``, ``ControlLDM.encode_text`` and
``EDTRPipeline.restore`` without ``c_txt``) against ``edtr_tpu`` on the CPU.

* Token ids: equal to JAX's ``tokenize`` exactly (the port reads its own
  copy of the BPE table).
* The tower at tiny width (64, 4 heads, 2 layers), penultimate and last
  layer, in fp32 and bf16, on ids below the tiny vocabulary of 512 (SOT and
  EOT are 49406/49407, so prompts do not fit it): relative L2 <= 3e-3
  against JAX's tower on the same weights.
* The bridge: the port's state dict back through JAX's own
  ``convert_clip_text`` gives the JAX tree exactly.
* The tiny flagship's ``restore(c_txt=None)`` against JAX's, with a CLIP of
  vocabulary 49408 (width 64, 2 layers) on both sides, at the tolerances of
  ``test_torch_pipeline.py``; and equal to ``restore(encode_text(...))``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as G
from edtr_tpu.data import tokenizer as JT
from edtr_tpu.models.clip import CLIPTextEncoder as JCLIP
from edtr_tpu.utils import convert as C
from edtr_torch.data import tokenizer as TT
from edtr_torch.models.clip import CLIPTextEncoder
from edtr_torch.pipeline import build_flagship
from edtr_torch.utils.convert import from_jax
from test_torch_pipeline import _replay_noise
from torch_port_helpers import IMAGE, cheap_jit, load_port, random_tree, t2n

TINY = dict(vocab_size=512, width=64, heads=4, layers=2)
TOL_REL = 3e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes need one thread; the suite runs several test processes on
    a few cores, and torch's own pool in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

PROMPTS = [
    "",
    "a photo of a cat, sitting on a mat!!! (really?) #1 -- 42%",
    "Ünïcödé naïve café — 東京 😀",
    "  MiXeD   Case\tand\n whitespace  ",
    " ".join(["restoration"] * 90) + " of degraded images",  # past 77 tokens
]


@pytest.mark.parametrize("prompt", PROMPTS, ids=["empty", "punct", "non_ascii", "case_ws",
                                                  "long"])
def test_tokenize_matches_jax(prompt):
    got = TT.tokenize([prompt, "x"])
    want = JT.tokenize([prompt, "x"])
    assert got.dtype == want.dtype == np.int32 and got.shape == (2, 77)
    np.testing.assert_array_equal(got, want)
    tk = TT.get_tokenizer()
    assert got[0, 0] == tk.sot_token == 49406
    assert tk.eot_token == 49407 and tk.eot_token in got[0]
    if prompt.startswith(" ".join(["restoration"] * 2)):
        assert got[0, -1] == tk.eot_token  # truncated, EOT forced at slot 77


def test_tokenizer_reads_the_ports_table():
    assert TT.DEFAULT_BPE_PATHS[-1].endswith("edtr_torch/data/bpe_simple_vocab_16e6.txt.gz")
    assert len(TT.get_tokenizer().bpe_ranks) == 49152 - 256 - 2


def test_empty_prompt_needs_no_table(monkeypatch):
    monkeypatch.setattr(TT, "DEFAULT_BPE_PATHS", [""])
    tk = TT.SimpleTokenizer()
    assert tk.encode("") == [] and not tk.bpe_ranks
    with pytest.raises(RuntimeError, match="EDTR_BPE_PATH"):
        tk.encode("a cat")


@functools.lru_cache(maxsize=None)
def _tower(penultimate: bool, vocab: int = 512):
    """(JAX tower, its random tree) at tiny width."""
    net = JCLIP(**dict(TINY, vocab_size=vocab), penultimate=penultimate)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32))
    return net, random_tree(shapes["params"], seed=31 + penultimate)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("penultimate", [True, False], ids=["penultimate", "last"])
def test_tower_matches_jax(penultimate, dtype):
    net, params = _tower(penultimate)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    ids = np.random.default_rng(3).integers(0, 512, (2, 77)).astype(np.int32)
    want = cheap_jit(lambda p, t: JCLIP(**TINY, penultimate=penultimate, dtype=jdt).apply(
        {"params": p}, t))(params, ids)
    port = CLIPTextEncoder(**TINY, penultimate=penultimate,
                           dtype=getattr(torch, dtype) if jdt else None)
    port.load_state_dict(from_jax(params, "clip"), strict=True)
    assert len(port.transformer.resblocks) == (1 if penultimate else 2)
    with torch.no_grad():
        got = port(ids)
    assert got.dtype == torch.float32 and got.shape == (2, 77, 64)
    rel = _rel(t2n(got), np.asarray(want))
    print(f"clip {dtype} {'penultimate' if penultimate else 'last'}: relative L2 {rel}")
    assert rel <= TOL_REL, rel


def test_bridge_round_trips():
    _, params = _tower(True)
    sd = {k: v.numpy() for k, v in from_jax(params, "clip").items()}
    back = C.convert_clip_text(sd, prefix="", layers=1)
    jax.tree.map(np.testing.assert_array_equal, back, jax.tree.map(np.asarray, params))
    prefixed = C.convert_clip_text({"model." + k: v for k, v in sd.items()}, layers=1)
    jax.tree.map(np.testing.assert_array_equal, prefixed, back)


def test_ids_outside_the_vocabulary_raise():
    port = CLIPTextEncoder(**TINY)
    ids = np.zeros((1, 77), np.int64)
    ids[0, 3] = 512
    with pytest.raises(ValueError, match=r"\[0, 512\)"):
        port(ids)
    ids[0, 3] = -1
    with pytest.raises(ValueError, match=r"\[0, 512\)"):
        port(torch.from_numpy(ids))
    with pytest.raises(ValueError, match=r"\[0, 512\)"):
        port.encode([""])  # SOT 49406 does not fit the toy vocabulary


@functools.lru_cache(maxsize=1)
def _restore_pair():
    """The tiny flagship on both sides with a CLIP of the real vocabulary
    (width 64, 2 layers, penultimate), one random tree."""
    pipe = G._flagship_pipeline(dtype=None, tiny=True)
    pipe.cldm.clip = JCLIP(**dict(TINY, vocab_size=49408), penultimate=True)

    def init(key):
        ks = jax.random.split(key, 2)
        p = pipe.cldm.init_params(ks[0], latent_hw=IMAGE // 8)
        p["swinir"] = pipe.swinir.init(ks[1], jnp.zeros((1, IMAGE, IMAGE, 3)))["params"]
        return p

    params = random_tree(jax.eval_shape(init, jax.random.PRNGKey(0)), seed=5)
    port = build_flagship(tiny=True, dtype=None, device="cpu")
    port.cldm.clip = CLIPTextEncoder(**dict(TINY, vocab_size=49408))
    load_port(port, params)
    return pipe, params, port.eval()


def test_restore_without_c_txt_matches_jax():
    pipe, params, port = _restore_pair()
    lq = np.random.default_rng(22).random((2, IMAGE, IMAGE, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(232)
    out_j = cheap_jit(lambda p, x, r: pipe.restore(p, x, r))(params, jnp.asarray(lq), rng)
    hw = IMAGE // 8
    noise, step_noise = _replay_noise(rng, (2, hw, hw, 4), len(pipe.used_timesteps))
    args = dict(noise=torch.from_numpy(noise), step_noise=torch.from_numpy(step_noise))
    out_t = port.restore(torch.from_numpy(lq), **args)
    for name, tol in (("pre_restored", 2e-3), ("z", 5e-3), ("restored", 1e-2)):
        a, b = t2n(out_t[name]), np.asarray(out_j[name])
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)
    # the embedding itself, and the restore with it given
    c_txt = port.cldm.encode_text(["", ""])
    want = pipe.cldm.encode_text(params, ["", ""])
    assert _rel(t2n(c_txt), np.asarray(want)) <= TOL_REL
    given = port.restore(torch.from_numpy(lq), c_txt, **args)
    for name in ("pre_restored", "z", "restored"):
        torch.testing.assert_close(given[name], out_t[name], rtol=0, atol=0)


def test_prepare_condition():
    _, _, port = _restore_pair()
    img = torch.rand(1, 3, IMAGE, IMAGE)
    cond = port.cldm.prepare_condition(img)
    torch.testing.assert_close(cond["c_txt"], port.cldm.encode_text([""]), rtol=0, atol=0)
    torch.testing.assert_close(cond["c_img"], port.cldm.vae_encode(img * 2 - 1), rtol=0, atol=0)
    words = port.cldm.prepare_condition(img, ["a restored photo"])["c_txt"]
    assert not torch.equal(words, cond["c_txt"])
