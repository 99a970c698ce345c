"""The port's real-world demo (``edtr_torch.demo.restore_and_detect``) and
its checkpoint (``edtr_torch.utils.checkpoint.load_combined``) against the
steps ``demo.py`` composes from ``edtr_tpu``'s functions, on the CPU, on
``__graft_entry__._flagship_pipeline(tiny=True)`` and the tiny
ResNet50-FPN-v2 detector (one numpy-drawn tree on both sides), at 128 x 192
(``pad_size`` 128: the CLI's 512 pads to 512 first):

* untiled, and with the encoder, the walk and the decoder on small tiles
  (SwinIR tiles only from 512 pixels up, as ``demo.py`` decides): the
  restored image at 1e-2 (the tiny restore's range, 2e-3 to 1e-2), on the
  same q_sample noise and the walk's noise replayed from JAX's key splits;
* each detection mode (``resize``, ``tile``, ``direct``) on the port's
  restored image, JAX's ``demo.py`` steps on the same image: valid and
  labels equal, boxes at 1e-5 of the image's size, scores at 3e-3;
* SwinIR on Gaussian-blended tiles (``pipe.pre_restore(x, tile)``) against
  JAX's ``make_tiled_fn`` of the tiny SwinIR at 1e-4;
* ``load_combined`` round trip, and its refusals.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edtr_tpu.diffusion.sampler import sample_scan
from edtr_tpu.ops import boxes as JB
from edtr_tpu.utils.image import wavelet_reconstruction
from edtr_tpu.utils.tiling import make_tiled_fn, sliding_windows, tiled_model_fn
from edtr_torch.demo import TILE_SCORE_MIN, detect, restore_and_detect
from edtr_torch.models import faster_rcnn as TF
from edtr_torch.pipeline import build_flagship
from edtr_torch.utils.checkpoint import load_combined
from test_torch_detection import _detector_v2, _port_loaded_v2
from torch_port_helpers import CTX, jax_tiny, nchw, nhwc, port_tiny, t2n

H, W = 128, 192
# 2 encoder tiles in each of its passes, 2 decoder tiles in each, 2 latent
# tiles: every tiled step on tiles that overlap and blend
TILED = dict(vae_encoder_tiled=True, vae_encoder_tile_size=128, vae_decoder_tiled=True,
             vae_decoder_tile_size=16, cldm_tiled=True, cldm_tile_size=128,
             cldm_tile_stride=64)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes need one thread; the suite runs several test processes on
    a few cores, and torch's own pool in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    g = np.random.default_rng(50)
    image = g.random((1, H, W, 3)).astype(np.float32)
    c_txt = g.standard_normal((1,) + CTX).astype(np.float32)
    noise = g.standard_normal((1, H // 8, W // 8, 4)).astype(np.float32)
    key, step_noise = jax.random.PRNGKey(51), []
    for _ in range(4):  # sample_scan: one split of the carried key a step
        key, sub = jax.random.split(key)
        step_noise.append(np.asarray(jax.random.normal(sub, noise.shape, jnp.float32)))
    return image, c_txt, noise, np.stack(step_noise)


@functools.lru_cache(maxsize=None)
def _jax_restore(tiled: bool) -> np.ndarray:
    """``demo.py``'s restore steps on JAX's tiny pipeline: pre-restore,
    encode (the mode), q_sample, the walk (its model on latent tiles when
    ``tiled``), decode, the wavelet fix."""
    pipe, params = jax_tiny()
    image, c_txt, noise, _ = _inputs()
    opts = TILED if tiled else {}
    cldm = pipe.cldm
    # each step jitted: one compile each, where op-by-op dispatch compiles
    # every primitive on its own (the SwinIR and the encoder ~5x slower)
    pre = jax.jit(pipe.pre_restore)(params, jnp.asarray(image))
    z_pre = jax.jit(lambda p, x: cldm.vae_encode(
        p, x, sample=False, tiled=opts.get("vae_encoder_tiled", False),
        tile_size=opts.get("vae_encoder_tile_size", -1)))(params, pre * 2 - 1)
    t = jnp.full((1,), pipe.start_timestep, jnp.int32)
    z_t = pipe.diffusion.q_sample(z_pre, t, jnp.asarray(noise))

    def walk(p, z_t, c_img):
        model_fn = cldm.model_fn(p)
        if tiled:
            model_fn = tiled_model_fn(model_fn, opts["cldm_tile_size"] // 8,
                                      opts["cldm_tile_stride"] // 8)
        return sample_scan(model_fn, pipe.schedule, z_t, dict(c_txt=jnp.asarray(c_txt),
                                                              c_img=c_img),
                           jax.random.PRNGKey(51))

    z = jax.jit(walk)(params, z_t, z_pre)

    def decode(p, z, pre):
        decoded = (cldm.vae_decode(p, z, tiled=opts.get("vae_decoder_tiled", False),
                                   tile_size=opts.get("vae_decoder_tile_size", -1)) + 1) / 2
        return wavelet_reconstruction(decoded, pre)

    return np.asarray(jax.jit(decode)(params, z, pre))


@functools.lru_cache(maxsize=1)
def _port_detector():
    """The tiny v2 detector in the port, JAX's weights (detection only here:
    nothing changes it)."""
    return _port_loaded_v2()


@functools.lru_cache(maxsize=None)
def _port_demo(tiled: bool) -> dict:
    image, c_txt, noise, step_noise = _inputs()
    return restore_and_detect(port_tiny(), _port_detector(), torch.from_numpy(image),
                              pad_size=128, noise=nchw(noise),
                              step_noise=torch.from_numpy(step_noise).permute(0, 1, 4, 2, 3),
                              c_txt=torch.from_numpy(c_txt), **(TILED if tiled else {}))


@pytest.mark.parametrize("tiled", [False, True], ids=["untiled", "tiled"])
def test_demo_restore_matches_jax(tiled):
    got = _port_demo(tiled)
    want = _jax_restore(tiled)
    assert tuple(got["restored"].shape) == want.shape == (1, H, W, 3)
    np.testing.assert_allclose(t2n(got["restored"]), want, rtol=1e-2, atol=1e-2)
    if tiled:  # the tiles change the image: the comparison reads them
        assert np.abs(want - _jax_restore(False)).max() > 1e-3


def _jax_detect(res: np.ndarray, detection_type: str, floor: float) -> dict:
    """``demo.py``'s detection steps on ``res`` (1, H, W, 3), JAX's tiny v2;
    ``floor``: the tile detections' score floor."""
    det, variables, _ = _detector_v2()
    fn = jax.jit(lambda im: det.apply(variables, im)[0])
    res = jnp.asarray(res)
    if detection_type == "resize":
        s = 512 / max(res.shape[1:3])
        rh, rw = int(res.shape[1] * s), int(res.shape[2] * s)
        pred = {k: np.asarray(v[0]) for k, v in fn(jax.image.resize(res, (1, rh, rw, 3),
                                                                    "bilinear")).items()}
        pred["boxes"] = pred["boxes"] / s
        return pred
    if detection_type == "direct":
        return {k: np.asarray(v[0]) for k, v in fn(res).items()}
    all_b, all_s, all_l = [], [], []
    for hi, hi_end, wi, wi_end in sliding_windows(res.shape[1], res.shape[2], 64, 64):
        p = {k: np.asarray(v[0]) for k, v in fn(res[:, hi:hi_end, wi:wi_end]).items()}
        keep = (p["scores"] >= floor) & p["valid"]
        all_b.append(p["boxes"][keep] + np.array([wi, hi, wi, hi]))
        all_s.append(p["scores"][keep])
        all_l.append(p["labels"][keep])
    boxes, scores, labels = (np.concatenate(a) for a in (all_b, all_s, all_l))
    assert len(boxes)  # demo.py skips the NMS of no box
    keep = np.asarray(JB.batched_nms_mask(jnp.asarray(boxes, jnp.float32), jnp.asarray(scores),
                                          jnp.asarray(labels), 0.3))
    return dict(boxes=boxes[keep], scores=scores[keep], labels=labels[keep],
                valid=np.ones(int(keep.sum()), bool))


@pytest.mark.parametrize("detection_type", ["resize", "tile", "direct"])
def test_demo_detection_modes_match_jax(detection_type, monkeypatch):
    """On the port's restored image. The tiny random detector scores no tile
    detection at ``demo.py``'s floor of 0.6, so both sides take 0.2 here:
    the offsets, the floor and the NMS across tiles then act on boxes."""
    floor = 0.2 if detection_type == "tile" else TILE_SCORE_MIN
    monkeypatch.setattr("edtr_torch.demo.TILE_SCORE_MIN", floor)
    res = _port_demo(False)["restored"]
    if detection_type == "resize":  # restore_and_detect's own call, its default mode
        got = _port_demo(False)["detections"]
    else:
        with torch.no_grad():
            got = detect(_port_detector(), res.permute(0, 3, 1, 2), detection_type, 64, 64)
    want = _jax_detect(t2n(res), detection_type, floor)
    dets = {k: v.numpy() for k, v in got.items()}
    if detection_type == "tile":  # padded, in tile order; JAX's compacted, same order
        assert dets["valid"].shape == (6 * 8,)
        dets = {k: v[dets["valid"]] for k, v in dets.items()}
        assert len(dets["scores"]) == len(want["scores"])
        assert (dets["scores"] >= floor).all()
    np.testing.assert_array_equal(dets["valid"], want["valid"])
    np.testing.assert_array_equal(dets["labels"], want["labels"])
    np.testing.assert_allclose(dets["boxes"], want["boxes"], rtol=1e-5, atol=1e-5 * W)
    np.testing.assert_allclose(dets["scores"], want["scores"], rtol=3e-3, atol=3e-3)
    assert want["valid"].any()


def test_tiled_swinir_matches_jax():
    """SwinIR on Gaussian-blended tiles: the port's ``pre_restore(x, tile)``
    against ``make_tiled_fn`` of JAX's tiny SwinIR (demo.py's pre-restore
    from 512 pixels up, here on 32-pixel tiles at stride 16)."""
    pipe, params = jax_tiny()
    x = np.random.default_rng(52).random((1, 48, 80, 3)).astype(np.float32)
    want = make_tiled_fn(lambda t: pipe.swinir.apply({"params": params["swinir"]}, t),
                         32, 16)(jnp.asarray(x))
    got = port_tiny().pre_restore(nchw(x), (32, 16))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_load_combined_round_trip(tmp_path):
    """``{swinir, cldm, decoder, detnet}`` of the reference's keys (the
    detector's with torchvision's ``num_batches_tracked``) load strictly
    into fresh modules; an unknown part, a missing key or an unexpected one
    raises."""
    src, det = port_tiny(), _port_detector()
    sd_det = dict(det.state_dict())
    sd_det.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(7)
                   for k in list(sd_det) if k.endswith("running_mean")})
    decoder = {k: v + 1.0 for k, v in src.cldm.vae.decoder.state_dict().items()}
    combined = dict(swinir=src.swinir.state_dict(), cldm=src.cldm.state_dict(),
                    decoder=decoder, detnet=sd_det)
    path = str(tmp_path / "combined.pt")
    torch.save(combined, path)
    pipe = build_flagship(tiny=True, dtype=None, device="cpu")
    det2 = TF.fasterrcnn_resnet50_fpn_v2(num_classes=6, device="cpu")
    assert load_combined(path, pipe, det2) == ("swinir", "cldm", "decoder", "detnet")
    for a, b in ((pipe.swinir, src.swinir), (det2, det)):
        assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    got = pipe.cldm.state_dict()
    for k, v in src.cldm.state_dict().items():  # the decoder part over the cldm's
        want = decoder[k[len("vae.decoder."):]] if k.startswith("vae.decoder.") else v
        assert torch.equal(got[k], want), k
    bad = dict(combined, extra={})
    torch.save(bad, path)
    with pytest.raises(ValueError, match="unknown parts"):
        load_combined(path, pipe, det2)
    for drop in (True, False):  # a key missing, or one unexpected
        sw = dict(combined["swinir"])
        if drop:
            sw.pop(next(iter(sw)))
        else:
            sw["nonsense"] = torch.zeros(1)
        torch.save(dict(swinir=sw), path)
        with pytest.raises(ValueError, match="swinir"):
            load_combined(path, pipe)
    torch.save(dict(detnet=sd_det), path)
    with pytest.raises(ValueError, match="no module"):
        load_combined(path, pipe)
