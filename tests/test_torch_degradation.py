"""The port's degradations (``edtr_torch.data.degradation``, ``diffjpeg``,
``realesrgan``) against ``edtr_tpu``'s on the same seeded inputs, on the
CPU in fp32 (the port NCHW, JAX NHWC):

* host copies, exact on the same ``Generator``: every blur kernel kind,
  the sinc kernel, Gaussian/Poisson noise, cv2 JPEG, ``codeformer_degrade``;
* ``filter2d`` (per-sample and shared kernels) 1e-6 abs;
* USM 1e-6 abs outside the 51 x 51 footprints of the pixels whose mask
  (``|img - blur| * 255 > 10``) flips between the two summation orders: at
  most 1e-3 of the pixels flip, each within 1e-4 of the threshold in JAX;
* ``resize`` (``jax.image.resize``'s weights: area, bilinear, bicubic; up
  and down at quantised sizes) 1e-5 abs;
* the batched Gaussian and Poisson noise on JAX's draws 1e-4 abs;
* ``quality_to_factor`` to one ulp (XLA's fp32 division);
  ``diff_jpeg(differentiable=True)`` 1e-4 abs; hard ``diff_jpeg`` 1e-4 abs outside the 8 x 8 blocks (16 x 16 in the
  image for chroma) whose quantised coefficients flip: at most 1e-3 of the
  blocks flip, each where JAX's scaled coefficient lies within 1e-4 of a
  rounding tie;
* the whole ``RealESRGANBatchTransform`` on JAX's replayed draws (its
  ``_next_key`` and the noises' ``split(key, 4)`` / ``split(key, 3)``), at
  queue 0 and queue 8 over 3 calls: the same host plan (branches, sizes,
  qualities, the pool's permutation), every stage run on JAX's input of
  that stage and held at its tolerance above, GT at 1e-6, and LQ equal to
  JAX's but at pixels where the last stage's output lies within 255 x
  1e-5 of a rounding tie (at most 1e-3 of them), before and after the pool;
* ``prepare_batch``'s Real-ESRGAN branch: the transform's tensors, the LQ
  list cropped from them on their device.
"""

import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edtr_tpu.data import degradation as JD
from edtr_tpu.data import diffjpeg as JJ
from edtr_tpu.data import realesrgan as JR
from edtr_torch.data import degradation as TD
from edtr_torch.data import diffjpeg as TJ
from edtr_torch.data import realesrgan as TR
from edtr_torch.train import harness as TH

KINDS = ["iso", "aniso", "generalized_iso", "generalized_aniso", "plateau_iso",
         "plateau_aniso"]
STAGE_TOL = {"filter2d": 1e-6, "resize": 1e-5, "gaussian": 1e-4, "poisson": 1e-4,
             "diff_jpeg": 1e-4}
FLIP_SHARE = 1e-3
TIE = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def _images(seed, b=2, h=96, w=80):
    return np.random.default_rng(seed).random((b, h, w, 3)).astype(np.float32)


def _kernels(seed, b=2, k=21):
    k = np.random.default_rng(seed).random((b, k, k)).astype(np.float32)
    return k / k.sum((1, 2), keepdims=True)


# -- host copies -------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_random_kernels_match_jax(kind):
    for seed in range(4):
        args = ([kind], [1.0], 21, (0.2, 3), (0.2, 3), (-math.pi, math.pi), (0.5, 4), (1, 2))
        got = TD.random_mixed_kernels(*args, noise_range=(0.75, 1.25),
                                      rng=np.random.default_rng(seed))
        want = JD.random_mixed_kernels(*args, noise_range=(0.75, 1.25),
                                       rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
    for cutoff, size, pad in ((1.3, 13, 21), (2.9, 21, 0), (math.pi / 3, 7, 21)):
        np.testing.assert_array_equal(TD.circular_lowpass_kernel(cutoff, size, pad),
                                      JD.circular_lowpass_kernel(cutoff, size, pad))


def test_host_noise_jpeg_and_codeformer_match_jax():
    img = _images(1, b=1, h=48, w=40)[0]
    for gray in (False, True):
        for mod_t, mod_j, name in ((TD, JD, "add_gaussian_noise"), (TD, JD, "add_poisson_noise")):
            got = getattr(mod_t, name)(img, 5, gray_noise=gray, rng=np.random.default_rng(3))
            want = getattr(mod_j, name)(img, 5, gray_noise=gray, rng=np.random.default_rng(3))
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TD.add_jpg_compression(img, 40), JD.add_jpg_compression(img, 40))
    for seed in range(3):
        kw = dict(blur_kernel_size=21, downsample_range=(1, 4))
        np.testing.assert_array_equal(
            TD.codeformer_degrade(img, rng=np.random.default_rng(seed), **kw),
            JD.codeformer_degrade(img, rng=np.random.default_rng(seed), **kw))


# -- device ops ----------------------------------------------------------------------

@pytest.mark.parametrize("shared", [False, True])
def test_filter2d_matches_jax(shared):
    x = _images(2)
    k = _kernels(3)[0] if shared else _kernels(3)
    got = nhwc(TD.filter2d(nchw(x), torch.from_numpy(k)))
    want = np.asarray(JD.filter2d(jnp.asarray(x), jnp.asarray(k)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _footprint(flips: np.ndarray, radius: int) -> np.ndarray:
    """Pixels within ``radius`` (Chebyshev) of a flipped pixel, (B, H, W)."""
    t = torch.from_numpy(flips.astype(np.float32))[:, None]
    return (torch.nn.functional.max_pool2d(t, 2 * radius + 1, 1, radius)[:, 0] > 0).numpy()


def test_usm_matches_jax_outside_mask_flips():
    x = _images(4, b=3, h=72, w=64)
    usm_t, usm_j = TR.USMSharp(), JR.USMSharp()
    np.testing.assert_array_equal(usm_t.kernel, usm_j.kernel)
    got = nhwc(usm_t(nchw(x)))
    want = np.asarray(usm_j(jnp.asarray(x)))
    k = jnp.asarray(usm_j.kernel)
    res_j = np.asarray(jnp.asarray(x) - JD.filter2d(jnp.asarray(x), k))
    res_t = nhwc(nchw(x) - TD.filter2d(nchw(x), torch.from_numpy(usm_t.kernel)))
    flips = (np.abs(res_j) * 255 > 10) != (np.abs(res_t) * 255 > 10)
    assert flips.mean() <= FLIP_SHARE
    assert np.all(np.abs(np.abs(res_j[flips]) * 255 - 10) <= TIE)
    outside = ~_footprint(flips.any(-1), 25)
    np.testing.assert_allclose(got[outside], want[outside], rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["area", "bilinear", "bicubic"])
def test_resize_matches_jax(mode):
    x = _images(5)
    for h, w in ((48, 32), (16, 16), (144, 160), (96, 32), (128, 80)):
        got = nhwc(TR.resize(nchw(x), h, w, mode))
        want = np.asarray(JR._resize(jnp.asarray(x), h, w, mode))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=f"{h}x{w}")
    assert TR._quantize_size(96 * 0.3) == JR._quantize_size(96 * 0.3)


class _Replay:
    """JAX's device draws, key by key: the transform's ``_next_key`` and
    each noise's own splits, as NCHW tensors (the port's ``noise_draws``)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    @staticmethod
    def draws(key, kind, shape, rng_range):
        b, c, h, w = shape
        ks = jax.random.split(key, 4 if kind == "gaussian" else 3)
        u = jax.random.uniform(ks[0], (b, 1, 1, 1), minval=rng_range[0], maxval=rng_range[1])
        gray = jax.random.uniform(ks[1], (b, 1, 1, 1))
        out = {"sigma" if kind == "gaussian" else "scale": torch.tensor(np.asarray(u).ravel()),
               "gray": torch.tensor(np.asarray(gray).ravel()),
               "noise": nchw(jax.random.normal(ks[2], (b, h, w, c), jnp.float32))}
        if kind == "gaussian":
            out["noise_gray"] = nchw(jax.random.normal(ks[3], (b, h, w, 1), jnp.float32))
        return out

    def __call__(self, kind, shape, rng_range):
        return self.draws(self.next_key(), kind, shape, rng_range)


@pytest.mark.parametrize("kind", ["gaussian", "poisson"])
@pytest.mark.parametrize("clip,rounds", [(True, False), (False, True), (True, True)])
def test_batched_noise_matches_jax_on_its_draws(kind, clip, rounds):
    x = _images(6, b=4)
    key = jax.random.PRNGKey(7)
    rng_range = (1, 30) if kind == "gaussian" else (0.05, 3)
    fn_j = {"gaussian": JD.random_add_gaussian_noise_jax,
            "poisson": JD.random_add_poisson_noise_jax}[kind]
    fn_t = {"gaussian": TD.random_add_gaussian_noise_pt,
            "poisson": TD.random_add_poisson_noise_pt}[kind]
    want = np.asarray(fn_j(key, jnp.asarray(x), rng_range, gray_prob=0.5, clip=clip,
                           rounds=rounds))
    draws = _Replay.draws(key, kind, nchw(x).shape, rng_range)
    assert bool((draws["gray"] < 0.5).any()) and bool((draws["gray"] >= 0.5).any())
    got = nhwc(fn_t(nchw(x), rng_range, 0.5, clip, rounds, draws=draws))
    if rounds:  # a tie of the 1/255 rounding flips one level
        diff = np.abs(got - want)
        assert (diff > 1e-4).mean() <= FLIP_SHARE
        np.testing.assert_allclose(diff[diff > 1e-4], 1 / 255, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # draws from a generator on the image's device when none are given
    g = torch.Generator().manual_seed(0)
    out = fn_t(nchw(x), rng_range, 0.5, generator=g)
    assert out.shape == nchw(x).shape and bool(torch.isfinite(out).all())


def test_quality_to_factor_matches_jax():
    q = np.array([1, 10, 30.5, 49.9, 50, 75, 95, 100], np.float32)
    np.testing.assert_array_max_ulp(TJ.quality_to_factor(torch.from_numpy(q)).numpy(),
                                    np.asarray(JJ.quality_to_factor(jnp.asarray(q))), maxulp=1)


def _scaled_coefficients(x: np.ndarray, q: np.ndarray, side: str):
    """Each component's DCT coefficients over its quantisation step,
    (B, blocks, 8, 8), and the component's width in blocks."""
    if side == "jax":
        b, h, w, _ = x.shape
        ph, pw = (16 - h % 16) % 16, (16 - w % 16) % 16
        xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, ph), (0, pw), (0, 0)))
        ycc = JJ.rgb_to_ycbcr(xp * 255.0)
        comps = [ycc[..., 0], JJ._avg_pool_2x2(ycc[..., 1]), JJ._avg_pool_2x2(ycc[..., 2])]
        factor = np.asarray(JJ.quality_to_factor(jnp.asarray(q)))
        out = []
        for comp, table in zip(comps, (JJ.Y_TABLE, JJ.C_TABLE, JJ.C_TABLE)):
            coefs = np.asarray(JJ.block_dct(JJ._blockify(comp)))
            out.append((coefs / (table[None, None] * factor[:, None, None, None]),
                        comp.shape[2] // 8))
        return out
    t = nchw(x)
    b, _, h, w = t.shape
    ph, pw = (16 - h % 16) % 16, (16 - w % 16) % 16
    ycc = TJ.rgb_to_ycbcr(torch.nn.functional.pad(t, (0, pw, 0, ph)) * 255.0)
    comps = [ycc[:, 0], TJ._avg_pool_2x2(ycc[:, 1]), TJ._avg_pool_2x2(ycc[:, 2])]
    factor = TJ.quality_to_factor(torch.from_numpy(q))
    out = []
    for comp, table in zip(comps, ("y", "c", "c")):
        coefs = TJ.block_dct(TJ._blockify(comp))
        out.append(((coefs / (TJ._table(table, t.device)[None, None]
                              * factor[:, None, None, None])).numpy(), comp.shape[2] // 8))
    return out


def _jpeg_flips(x: np.ndarray, q: np.ndarray):
    """(share of blocks flipped, (B, H, W) pixels of flipped blocks); every
    flip is asserted to sit within ``TIE`` of a rounding tie in JAX."""
    b, h, w, _ = x.shape
    mask = np.zeros((b, h + 16, w + 16), bool)
    flipped = total = 0
    for ci, ((sj, cw), (st, _)) in enumerate(zip(_scaled_coefficients(x, q, "jax"),
                                                 _scaled_coefficients(x, q, "port"))):
        flip = np.round(sj) != np.round(st)
        tie = np.abs(np.abs(sj - np.floor(sj)) - 0.5)
        assert np.all(tie[flip] <= TIE), tie[flip]
        blocks = flip.any((2, 3))
        flipped += int(blocks.sum())
        total += blocks.size
        px = 8 if ci == 0 else 16
        for bi, n in zip(*np.nonzero(blocks)):
            y0, x0 = (n // cw) * px, (n % cw) * px
            mask[bi, y0:y0 + px, x0:x0 + px] = True
    return flipped / total, mask[:, :h, :w]


def _assert_jpeg_close(got, want, x, q):
    share, mask = _jpeg_flips(x, q)
    assert share <= FLIP_SHARE, share
    np.testing.assert_allclose(got[~mask], want[~mask], rtol=0, atol=STAGE_TOL["diff_jpeg"])


@pytest.mark.parametrize("differentiable", [False, True])
def test_diff_jpeg_matches_jax(differentiable):
    for seed, (h, w) in ((8, (96, 80)), (9, (50, 70))):
        x = _images(seed, b=3, h=h, w=w)
        q = np.array([30.5, 62.0, 94.9], np.float32)
        got = nhwc(TJ.diff_jpeg(nchw(x), torch.from_numpy(q), differentiable))
        want = np.asarray(JJ.diff_jpeg(jnp.asarray(x), jnp.asarray(q), differentiable))
        if differentiable:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        else:
            _assert_jpeg_close(got, want, x, q)
    jpeger = TJ.DiffJPEG(differentiable)
    np.testing.assert_array_equal(nhwc(jpeger(nchw(x), 50)),
                                  nhwc(TJ.diff_jpeg(nchw(x), 50, differentiable)))


# -- the whole transform -------------------------------------------------------------

class _StageRecorder:
    """JAX's transform, each stage's input and output recorded."""

    NAMES = {"filter2d": "filter2d", "_resize": "resize",
             "random_add_gaussian_noise_jax": "gaussian",
             "random_add_poisson_noise_jax": "poisson", "diff_jpeg": "diff_jpeg"}

    def __init__(self):
        self.stages = []
        self.pre_queue = []

    def patches(self):
        out = []
        for attr, name in self.NAMES.items():
            fn = getattr(JR, attr)
            img_arg = 1 if name in ("gaussian", "poisson") else 0

            def wrap(*args, _fn=fn, _name=name, _i=img_arg, **kw):
                y = _fn(*args, **kw)
                self.stages.append((_name, np.asarray(args[_i]), args, np.asarray(y)))
                return y
            out.append(mock.patch.object(JR, attr, wrap))
        deq = JR.RealESRGANBatchTransform._dequeue_and_enqueue

        def dequeue(tr, values):
            self.pre_queue.append({k: np.asarray(v) for k, v in values.items()})
            return deq(tr, values)
        out.append(mock.patch.object(JR.RealESRGANBatchTransform, "_dequeue_and_enqueue",
                                     dequeue))
        return out


class _StageForcer:
    """The port's transform, each stage run on JAX's input of that stage and
    its output held to JAX's at the stage's tolerance."""

    NAMES = {"filter2d": "filter2d", "resize": "resize",
             "random_add_gaussian_noise_pt": "gaussian",
             "random_add_poisson_noise_pt": "poisson", "diff_jpeg": "diff_jpeg"}

    def __init__(self, stages):
        self.stages = list(stages)
        self.last = None
        self.pre_queue = []
        self.held = []

    def patches(self):
        out = []
        for attr, name in self.NAMES.items():
            fn = getattr(TR, attr)

            def wrap(img, *args, _fn=fn, _name=name, **kw):
                want_name, x_j, args_j, y_j = self.stages.pop(0)
                assert want_name == _name
                assert tuple(img.shape) == nchw(x_j).shape, (_name, img.shape, x_j.shape)
                y = _fn(nchw(x_j), *args, **kw)
                got = nhwc(y)
                assert got.shape == y_j.shape, _name
                if _name == "diff_jpeg":
                    _assert_jpeg_close(got, y_j, x_j, np.asarray(args_j[1]))
                else:
                    np.testing.assert_allclose(got, y_j, rtol=0, atol=STAGE_TOL[_name],
                                               err_msg=_name)
                self.held.append(_name)
                self.last = y_j
                return y
            out.append(mock.patch.object(TR, attr, wrap))
        deq = TR.RealESRGANBatchTransform._dequeue_and_enqueue

        def dequeue(tr, values, perm, perm_host):
            self.pre_queue.append({k: v.numpy() for k, v in values.items()})
            return deq(tr, values, perm, perm_host)
        out.append(mock.patch.object(TR.RealESRGANBatchTransform, "_dequeue_and_enqueue",
                                     dequeue))
        return out


def _assert_lq(got, want, last=None):
    """LQ equal to JAX's but for one-level rounding flips (at most
    ``FLIP_SHARE``), each at a tie of the last stage's output when given."""
    diff = np.abs(got - want)
    flips = diff > 0
    assert flips.mean() <= FLIP_SHARE, flips.mean()
    np.testing.assert_allclose(diff[flips], 1 / 255, atol=1e-6)
    if last is not None:
        v = np.clip(last * 255.0, 0, 255)
        assert np.all(np.abs(np.abs(v - np.floor(v)) - 0.5)[flips] <= 255 * STAGE_TOL["resize"])


def _batch(g, b=4, size=64):
    k = g.random((3, b, 21, 21)).astype(np.float32)
    k /= k.sum((2, 3), keepdims=True)
    return dict(hq=g.random((b, size, size, 3)).astype(np.float32), kernel1=k[0],
                kernel2=k[1], sinc_kernel=k[2])


@pytest.mark.parametrize("queue_size", [0, 8])
def test_transform_matches_jax_stage_by_stage(queue_size):
    seed = 3 + queue_size
    jt = JR.RealESRGANBatchTransform(seed=seed, queue_size=queue_size)
    tt = TR.RealESRGANBatchTransform(seed=seed, queue_size=queue_size, device="cpu")
    replay = _Replay(seed)
    tt.noise_draws = replay
    g = np.random.default_rng(30 + queue_size)
    held = set()
    for call in range(3):
        batch = _batch(g)
        rec = _StageRecorder()
        ps = rec.patches()
        for p in ps:
            p.start()
        try:
            want = JR.RealESRGANBatchTransform.__call__(jt, batch)
        finally:
            for p in ps:
                p.stop()
        want = {k: np.asarray(v) for k, v in want.items()}
        last = rec.stages[-1][3]
        forcer = _StageForcer(rec.stages)
        ps = forcer.patches()
        for p in ps:
            p.start()
        try:
            got = tt(batch)
        finally:
            for p in ps:
                p.stop()
        assert not forcer.stages, "the port ran fewer stages than JAX"
        held.update(forcer.held)
        assert set(got) == set(want) == {"GT", "LQ"}
        for name in ("GT", "LQ"):
            assert isinstance(got[name], torch.Tensor) and got[name].device.type == "cpu"
            assert tuple(got[name].shape) == want[name].shape
        if queue_size:
            assert len(forcer.pre_queue) == len(rec.pre_queue) == 1
            np.testing.assert_allclose(forcer.pre_queue[0]["GT"], rec.pre_queue[0]["GT"],
                                       rtol=0, atol=1e-6)
            _assert_lq(forcer.pre_queue[0]["LQ"], rec.pre_queue[0]["LQ"], last)
            assert tt.queue_ptr == jt.queue_ptr
        np.testing.assert_allclose(got["GT"].numpy(), want["GT"], rtol=0, atol=1e-6)
        _assert_lq(got["LQ"].numpy(), want["LQ"], None if queue_size else last)
        assert not np.array_equal(got["LQ"].numpy(), got["GT"].numpy())
    assert held >= {"filter2d", "resize", "diff_jpeg"} and held & {"gaussian", "poisson"}
    assert replay.key.tolist() == jt._key.tolist()  # as many device draws as JAX


def test_prepare_batch_runs_the_transform_on_its_device():
    g = np.random.default_rng(12)
    sizes = ((64, 48), (40, 64), (64, 64), (32, 32))
    items = [(g.random((h, w, 3)).astype(np.float32), *_kernels(20 + i, b=3), {"boxes": []},
              f"p{i}") for i, (h, w) in enumerate(sizes)]
    tt = TR.RealESRGANBatchTransform(seed=1, queue_size=0, device="cpu")
    gt_list, lq_list, gt_b, lq_b, annots, paths, bs = TH.prepare_batch(
        TH.collate_fn(items), 64, batch_transform=tt)
    for a, item in zip(gt_list, items):
        np.testing.assert_array_equal(a, item[0])
    assert isinstance(gt_b, torch.Tensor) and isinstance(lq_b, torch.Tensor)
    assert gt_b.shape == lq_b.shape == (4, 64, 64, 3) and bs == 4 and paths == [
        f"p{i}" for i in range(4)]
    for lq, (h, w) in zip(lq_list, sizes):
        assert isinstance(lq, torch.Tensor) and lq.shape == (h, w, 3)
        assert lq.untyped_storage().data_ptr() == lq_b.untyped_storage().data_ptr()
    again = TR.RealESRGANBatchTransform(seed=1, queue_size=0, device="cpu")
    out = again(dict(hq=TH.list_to_batch(gt_list, 64),
                     kernel1=np.stack([i[1] for i in items]),
                     kernel2=np.stack([i[2] for i in items]),
                     sinc_kernel=np.stack([i[3] for i in items])))
    torch.testing.assert_close(out["LQ"], lq_b, rtol=0, atol=0)
