"""The training half of the port's detector against ``edtr_tpu`` on the CPU.

* ``encode_boxes`` at 1e-6; ``match_boxes`` exactly on tied IoUs, invalid
  GT rows and low-quality matches; ``balanced_sample``'s masks exactly, the
  uniforms replayed from JAX's key splits (``r1, r2 = split(rng)``).
* Train-mode BatchNorm (MobileNet: momentum 0.01, eps 1e-3): outputs and
  running statistics at 1e-5 against JAX's ``TorchBatchNorm``.
* The tiny detector (``__graft_entry__._tiny_detnet``'s knobs, with batch
  sizes per image at or above the candidate counts and positive fractions
  1.0, so sampling keeps every candidate and the draws do not matter) with
  targets against JAX's ``FasterRCNN(..., train=..., mutable=
  ["batch_stats"])``: the four losses at 1e-4 relative, parameter
  gradients at relative L2 <= 3e-3 (floored at 1e-3 of the largest leaf's
  norm), the running statistics at 1e-5. With the norms on running
  statistics (``train=False``, as a ``norm_frozen`` detector trains) every
  gradient holds to 3e-3. With batch statistics (``train=True``) the
  gradients are ill-conditioned in fp32 on these random weights: the port's
  own fp32 gradients differ from its fp64 ones by up to ~5e-3 (JAX's fp32
  ones from the port's fp64 ones by as much), so each leaf holds to 3e-3
  plus twice the port's fp32-vs-fp64 error of that leaf.
* ``detnet_trainable_mask`` against JAX's mask under the bridge's names,
  the ResNet branch of the v2 too.
* The ResNet50-FPN-v2's training call in train mode (every norm on batch
  statistics), its box head on JAX's proposals on both sides: losses at
  1e-4 relative, gradients and running statistics at 3e-3 / 1e-5 plus
  twice the fp32 error of either side (the port's fp32 against its fp64,
  JAX's fp32 against itself one ulp away).
* ``task_apply_for("det")`` against ``runner._task_apply_for("det", ...)``
  on the tiny detector (one ``jax.jit`` of both): the summed loss and the
  four losses at 1e-4 relative, the running statistics at 1e-5, the FPN
  ``"0"`` map on running statistics at 1e-5 of its largest value.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edtr_tpu.models import faster_rcnn as JF
from edtr_tpu.models.layers import TorchBatchNorm
from edtr_tpu.ops import boxes as JB
from edtr_tpu.train.runner import _task_apply_for
from edtr_torch.models import faster_rcnn as TF
from edtr_torch.models.mobilenetv3 import BatchNorm2d
from edtr_torch.ops import boxes as TB
from edtr_torch.train.tasks import task_apply_for
from edtr_torch.utils.convert import from_jax
from test_torch_detection import (DET_BATCH, DET_IMAGE, _boxes, _detector, _detector_v2,
                                  _jax_detect_v2, _port_detector_v2, _t)
from torch_port_helpers import cheap_jit, nchw, t2n

# sampling keeps every candidate: 540 anchors at 128² (the v2: 4092), 32
# proposals + 4 GT
TRAIN_KNOBS = dict(rpn_batch_size_per_image=1024, rpn_positive_fraction=1.0,
                   box_batch_size_per_image=64, box_positive_fraction=1.0)
TRAIN_KNOBS_V2 = dict(TRAIN_KNOBS, rpn_batch_size_per_image=4096)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes need one thread; the suite runs several test processes on
    a few cores, and torch's own pool in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_encode_boxes(weights):
    rng = np.random.default_rng(40)
    gt, anchors = _boxes(rng, 80), _boxes(rng, 80)
    anchors[:5, 2] = anchors[:5, 0]  # zero widths: the 1e-9 floor decides
    got = t2n(TB.encode_boxes(_t(gt), _t(anchors), weights))
    want = np.asarray(JB.encode_boxes(gt, anchors, weights))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # decode inverts it where no clamp acts
    back = t2n(TB.decode_boxes(_t(got[5:]), _t(anchors[5:]), weights))[:, 0]
    np.testing.assert_allclose(back, gt[5:], rtol=1e-4, atol=1e-3)


def _tied_iou(seed, b, g, n):
    """IoUs on a coarse grid (many exact ties, the thresholds themselves
    among them) with a fifth of the GT rows invalid."""
    rng = np.random.default_rng(seed)
    iou = (rng.integers(0, 11, (b, g, n)) / 10.0).astype(np.float32)
    valid = rng.random((b, g)) > 0.2
    valid[:, 0] = True
    return iou, valid


@pytest.mark.parametrize("low_quality", [True, False])
@pytest.mark.parametrize("high,low", [(0.7, 0.3), (0.5, 0.5)])
def test_match_boxes_exact(high, low, low_quality):
    iou, valid = _tied_iou(41, 3, 2, 200)
    got = TF.match_boxes(_t(iou), high, low, low_quality, _t(valid)).numpy()
    want = jax.vmap(lambda i, v: JF.match_boxes(i, high, low, low_quality, v))(iou, valid)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert {-1, -2} <= set(np.unique(got)) or high == low


def test_match_boxes_low_quality_restores_the_argmax():
    """A GT whose best IoU is under ``low``: its tied best anchors keep
    their own (first) best GT, not that GT."""
    iou = np.array([[[0.2, 0.2, 0.1], [0.2, 0.9, 0.0], [0.0, 0.0, 0.0]]], np.float32)
    valid = np.array([[True, True, False]])
    got = TF.match_boxes(_t(iou), 0.7, 0.3, True, _t(valid)).numpy()
    want = JF.match_boxes(iou[0], 0.7, 0.3, True, valid[0])
    np.testing.assert_array_equal(got[0], np.asarray(want))
    assert got.tolist() == [[0, 1, TF.BELOW_LOW]]


@pytest.mark.parametrize("batch,fraction", [(16, 0.25), (64, 0.5), (256, 0.5), (512, 1.0)])
def test_balanced_sample_exact(batch, fraction):
    rng = np.random.default_rng(42)
    n = 300
    pos = rng.random((4, n)) < 0.1
    neg = ~pos & (rng.random((4, n)) < 0.7)
    keys = jax.random.split(jax.random.PRNGKey(7), 4)
    want_p, want_n = jax.vmap(
        lambda k, p, q: JF.balanced_sample(k, p, q, batch, fraction))(keys, pos, neg)
    u = np.stack([[np.asarray(jax.random.uniform(r, (n,))) for r in jax.random.split(k)]
                  for k in keys])  # (4, 2, n): r1 -> positives, r2 -> negatives
    got_p, got_n = TF.balanced_sample(_t(pos), _t(neg), batch, fraction, _t(u[:, 0]),
                                      _t(u[:, 1]))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert (got_p.sum(1) + got_n.sum(1) <= batch).all()


def test_train_mode_batchnorm():
    rng = np.random.default_rng(43)
    x = (rng.standard_normal((2, 9, 7, 24)) * 3 + 1).astype(np.float32)  # NHWC
    bn = TorchBatchNorm(use_running_average=False, momentum=0.01, epsilon=1e-3,
                        dtype=jnp.float32)
    variables = {"params": {"scale": rng.random(24).astype(np.float32) + 0.5,
                            "bias": rng.standard_normal(24).astype(np.float32)},
                 "batch_stats": {"mean": rng.standard_normal(24).astype(np.float32),
                                 "var": rng.random(24).astype(np.float32) + 0.5}}
    want, new = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm2d(24)
    port.load_state_dict({"weight": _t(variables["params"]["scale"]),
                          "bias": _t(variables["params"]["bias"]),
                          "running_mean": _t(variables["batch_stats"]["mean"]),
                          "running_var": _t(variables["batch_stats"]["var"])})
    got = port(nchw(x), train=True)
    np.testing.assert_allclose(t2n(got).transpose(0, 2, 3, 1), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(new["batch_stats"][key]), rtol=1e-5, atol=1e-5)
    # running statistics, not updated, when train is off
    before = port.running_var.clone()
    ref = (nchw(x) - port.running_mean[:, None, None]) * (
        torch.rsqrt(port.running_var + 1e-3) * port.weight)[:, None, None]
    torch.testing.assert_close(port(nchw(x)), ref + port.bias[:, None, None])
    assert torch.equal(port.running_var, before)


def _targets():
    """Four GT slots an image, the last padded, labels in 1..5."""
    boxes = np.array([[[4, 6, 60, 70], [50, 20, 120, 100], [10, 80, 45, 126], [0, 0, 0, 0]],
                      [[30, 30, 100, 90], [0, 0, 64, 64], [70, 60, 127, 127], [0, 0, 0, 0]]],
                     np.float32)
    labels = np.array([[1, 3, 5, 0], [2, 2, 4, 0]], np.int32)
    valid = np.array([[True, True, True, False]] * DET_BATCH)
    return dict(boxes=boxes, labels=labels, valid=valid)


@functools.lru_cache(maxsize=None)
def _jax_train_fn(train: bool, v2: bool = False):
    """JAX's training call on the tiny detector (``v2``: the ResNet50-FPN-v2
    one, the box head on :func:`_v2_proposals`), jitted once: images ->
    ((loss, (losses, new batch_stats)), grads)."""
    det, variables, _ = _detector_v2() if v2 else _detector()
    det = det.clone(**(TRAIN_KNOBS_V2 if v2 else TRAIN_KNOBS))
    targets = {k: jnp.asarray(v) for k, v in _targets().items()}
    manual = _v2_proposals() if v2 else None

    def loss_fn(params, images):
        (_, losses, _), new = det.apply({"params": params,
                                         "batch_stats": variables["batch_stats"]},
                                        images, targets=targets, train=train,
                                        manual_proposals=manual, mutable=["batch_stats"],
                                        rngs={"sampler": jax.random.PRNGKey(3)})
        return sum(losses.values()), (losses, new["batch_stats"])

    fn = cheap_jit(jax.value_and_grad(loss_fn, has_aux=True))
    return lambda images: fn(variables["params"], images)


@functools.lru_cache(maxsize=None)
def _jax_train(train: bool, v2: bool = False, ulp_noise: bool = False):
    """(losses, grads, new batch_stats) of :func:`_jax_train_fn` on the
    batch; ``ulp_noise``: each pixel moved by one fp32 ulp up or down (a
    seeded sign), which reads how far JAX's own fp32 rounding moves the
    gradients."""
    images = (_detector_v2() if v2 else _detector())[2]
    if ulp_noise:
        sign = np.random.default_rng(46).choice([-1.0, 1.0], images.shape)
        images = (images * (1 + 2.0 ** -23 * sign)).astype(np.float32)
    (_, (losses, stats)), grads = _jax_train_fn(train, v2)(images)
    return losses, grads, stats


def _v2_proposals():
    """JAX's inference proposals of the tiny v2 detector, all valid: the
    box head's RoIs on both sides of the v2's training call. The RPN's
    top-k and NMS on its train-mode (batch-statistics) scores would pick
    RoIs 0.035 px apart on the two sides (the fp32 rounding of ResNet-50's
    batch-statistics norms on random weights, ~1e-4 of the FPN maps on
    either side), and the box losses move with them."""
    props = np.array(_jax_detect_v2()[2]["proposals"])
    return props, np.ones(props.shape[:2], bool)


def _port_train_detector(v2: bool = False):
    """The port's tiny detector with the training knobs, JAX's weights."""
    if v2:
        port = _port_detector_v2(rpn_pre_nms_top_n_train=64, rpn_post_nms_top_n_train=32,
                                 **TRAIN_KNOBS_V2)
        port.load_state_dict(from_jax(_detector_v2()[1], "fasterrcnn"), strict=True)
        return port
    _, variables, _ = _detector()
    port = TF.fasterrcnn_mobilenet_v3_large_fpn(
        num_classes=6, device="cpu", min_size=DET_IMAGE, max_size=DET_IMAGE * 2,
        rpn_pre_nms_top_n_train=64, rpn_pre_nms_top_n_test=64,
        rpn_post_nms_top_n_train=32, rpn_post_nms_top_n_test=32, box_detections_per_img=8,
        **TRAIN_KNOBS)
    port.load_state_dict(from_jax(variables, "fasterrcnn"), strict=True)
    return port


def _port_train(train: bool, dtype=torch.float32, v2: bool = False):
    """The port's training call on the same weights, images and targets:
    (model, losses), the gradients in the parameters' ``.grad``."""
    _, _, images = _detector()
    port = _port_train_detector(v2)
    port.to(dtype)
    targets = {k: _t(v) for k, v in _targets().items()}
    targets["boxes"] = targets["boxes"].to(dtype)
    manual = None
    if v2:
        props, valid = _v2_proposals()
        manual = (_t(props).to(dtype), _t(valid))
    _, losses, _ = port(nchw(images).to(dtype), targets=targets, train=train,
                        manual_proposals=manual, generator=torch.Generator().manual_seed(0))
    sum(losses.values()).backward()
    return port, {k: v.detach() for k, v in losses.items()}


def _leaf_errors(got: dict, want: dict) -> dict:
    """Relative L2 error of each leaf, its norm floored at 1e-3 of the
    largest leaf's."""
    floor = 1e-3 * max(float(g.norm()) for g in want.values())
    return {n: float((got[n].double() - want[n].double()).norm())
            / max(float(want[n].norm()), floor) for n in want}


@pytest.mark.parametrize("train", [False, True], ids=["running_stats", "batch_stats"])
def test_tiny_detector_losses_gradients_and_stats_match_jax(train):
    want_l, want_g, want_s = _jax_train(train)
    port, losses = _port_train(train)
    assert set(losses) == set(want_l)
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), float(want_l[k]), rtol=1e-4, err_msg=k)
        assert float(want_l[k]) > 0, k
    want = from_jax({"params": want_g, "batch_stats": {}}, "fasterrcnn")
    got = {n: p.grad for n, p in port.named_parameters()}
    assert set(got) == set(want)
    err = _leaf_errors(got, want)
    limit = {n: 3e-3 for n in want}
    if train:  # the body's fp32 rounding: the port's own, fp32 against fp64
        p64, _ = _port_train(train, torch.float64)
        own = _leaf_errors(got, {n: p.grad for n, p in p64.named_parameters()})
        limit.update({n: 3e-3 + 2 * own[n] for n in want})
        print("train-mode gradients: worst port vs JAX",
              max((e, n) for n, e in err.items()), "worst port fp32 vs fp64",
              max((e, n) for n, e in own.items()))
    bad = {n: (err[n], limit[n]) for n in want if err[n] > limit[n]}
    assert not bad, bad
    buffers = dict(port.named_buffers())
    stats = from_jax({"params": {}, "batch_stats": want_s}, "fasterrcnn")
    for n, v in stats.items():
        np.testing.assert_allclose(buffers[n].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=n)
    moved = [n for n, v in from_jax(_detector()[1], "fasterrcnn").items()
             if n in stats and not torch.equal(buffers[n], v)]
    assert bool(moved) == train


def test_tiny_v2_detector_losses_gradients_and_stats_match_jax():
    """The v2's training call in train mode (its norms are never frozen:
    body, FPN and box head on batch statistics, their running ones
    updated), the box head on JAX's proposals on both sides
    (:func:`_v2_proposals`): losses at 1e-4 relative, gradients at 3e-3
    plus twice the fp32 error of each leaf (the larger of the port's fp32
    against fp64 and JAX's fp32 against itself one ulp away), running
    statistics at 1e-5 plus twice their fp32 error so read, every norm's
    moved."""
    want_l, want_g, want_s = _jax_train(True, v2=True)
    port, losses = _port_train(True, v2=True)
    assert set(losses) == set(want_l)
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), float(want_l[k]), rtol=1e-4, err_msg=k)
    want = from_jax({"params": want_g, "batch_stats": {}}, "fasterrcnn")
    got = {n: p.grad for n, p in port.named_parameters()}
    assert set(got) == set(want)
    err = _leaf_errors(got, want)
    # the fp32 error of each leaf, as either side rounds: the port's fp32
    # against its fp64, and JAX's fp32 against itself on the batch moved by
    # one ulp (body norms' leaves move ~5% so, the coarsest FPN level's
    # ~1.5e-3, where the port's own rounding moves them ~1e-5)
    p64, _ = _port_train(True, torch.float64, v2=True)
    own = _leaf_errors(got, {n: p.grad for n, p in p64.named_parameters()})
    jax_own = _leaf_errors(from_jax({"params": _jax_train(True, True, True)[1],
                                     "batch_stats": {}}, "fasterrcnn"), want)
    limit = {n: 3e-3 + 2 * max(own[n], jax_own[n]) for n in want}
    bad = {n: (err[n], limit[n]) for n in want if err[n] > limit[n]}
    print("v2 train-mode gradients: worst port vs JAX", max((e, n) for n, e in err.items()),
          "worst port fp32 vs fp64", max((e, n) for n, e in own.items()),
          "worst JAX vs JAX moved one ulp", max((e, n) for n, e in jax_own.items()))
    assert not bad, bad
    buffers, b64 = dict(port.named_buffers()), dict(p64.named_buffers())
    stats = from_jax({"params": {}, "batch_stats": want_s}, "fasterrcnn")
    stats_ulp = from_jax({"params": {}, "batch_stats": _jax_train(True, True, True)[2]},
                         "fasterrcnn")
    assert {n for n in stats if ".fpn." in n or ".box_head." in n}
    for n, v in stats.items():  # 1e-5 plus twice either side's fp32 error, as above
        fp32_err = np.maximum((buffers[n].double() - b64[n]).abs().numpy(),
                              (stats_ulp[n] - v).abs().numpy())
        np.testing.assert_array_less(np.abs(buffers[n].numpy() - v.numpy()),
                                     1e-5 * (1 + np.abs(v.numpy())) + 2 * fp32_err + 1e-12,
                                     err_msg=n)
    before = from_jax(_detector_v2()[1], "fasterrcnn")
    assert all(not torch.equal(buffers[n], before[n]) for n in stats if n.endswith("_var"))


def test_v2_trainable_mask_matches_jax():
    """The ResNet branch: ``["layer4", "layer3", "layer2", "layer1",
    "conv1"][:trainable_layers]`` of the body train (``bn1`` never), the
    FPN and the heads always; JAX's mask under the bridge's names."""
    _, variables, _ = _detector_v2()
    params = variables["params"]
    port = _port_detector_v2()
    for layers in (3, 0, 5):
        jmask = JF.detnet_trainable_mask(params, "resnet50_fpn_v2", layers)
        full = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32), jmask,
                            params)
        want = {n: bool(v.all()) for n, v in from_jax({"params": full, "batch_stats": {}},
                                                     "fasterrcnn").items()}
        got = TF.detnet_trainable_mask(port, layers)
        assert got == want, layers
        assert {n: p.requires_grad for n, p in port.named_parameters()} == got
    frozen = {n.split(".")[2] for n, t in TF.detnet_trainable_mask(port).items() if not t}
    assert frozen == {"conv1", "bn1", "layer1"}


def test_norm_frozen_keeps_running_statistics():
    _, variables, images = _detector()
    port = TF.fasterrcnn_mobilenet_v3_large_fpn(num_classes=6, device="cpu",
                                                min_size=DET_IMAGE, norm_frozen=True,
                                                rpn_pre_nms_top_n_train=64,
                                                rpn_post_nms_top_n_train=32)
    port.load_state_dict(from_jax(variables, "fasterrcnn"), strict=True)
    before = {n: b.clone() for n, b in port.named_buffers()}
    port(nchw(images), targets={k: _t(v) for k, v in _targets().items()}, train=True,
         generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(b, before[n]) for n, b in port.named_buffers())


def test_trainable_mask_matches_jax():
    det, variables, _ = _detector()
    params = variables["params"]
    jmask = JF.detnet_trainable_mask(params)
    full = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32), jmask, params)
    want = {n: bool(v.all()) for n, v in from_jax({"params": full, "batch_stats": {}},
                                                 "fasterrcnn").items()}
    port = TF.fasterrcnn_mobilenet_v3_large_fpn(num_classes=6, device="cpu")
    got = TF.detnet_trainable_mask(port)
    assert got == want
    assert {n: p.requires_grad for n, p in port.named_parameters()} == got
    frozen = {n.split(".")[3] for n, t in got.items() if not t}
    assert frozen == {str(i) for i in range(7)}  # features 0-6: stage_indices[6 - 3] = 7
    assert all(TF.detnet_trainable_mask(port, 6).values())
    assert not any(t for n, t in TF.detnet_trainable_mask(port, 0).items()
                   if n.startswith("backbone.body."))


@functools.lru_cache(maxsize=1)
def _jax_task_det():
    """runner's det ``(loss_fn, feats_fn)`` on the tiny detector, one
    ``jax.jit``: (loss, losses, new batch_stats, FPN '0' map)."""
    det, variables, images = _detector()
    loss_fn, feats_fn = _task_apply_for("det", det.clone(**TRAIN_KNOBS))
    targets = {k: jnp.asarray(v) for k, v in _targets().items()}
    extra = {"batch_stats": variables["batch_stats"]}

    def run(params):
        loss, (losses, new) = loss_fn(params, extra, images, targets, jax.random.PRNGKey(3))
        return loss, losses, new["batch_stats"], feats_fn(params, extra, images)

    return jax.tree.map(np.asarray, cheap_jit(run)(variables["params"]))


def test_task_apply_for_det_matches_runner():
    loss_w, losses_w, stats_w, feats_w = _jax_task_det()
    _, _, images = _detector()
    port = _port_train_detector()
    loss_fn, feats_fn = task_apply_for("det")
    with torch.no_grad():
        feats = feats_fn(port, nchw(images))  # running statistics, before the loss's update
        loss, losses = loss_fn(port, nchw(images), {k: _t(v) for k, v in _targets().items()},
                               torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(loss), float(loss_w), rtol=1e-4)
    assert set(losses) == set(losses_w)
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), float(losses_w[k]), rtol=1e-4, err_msg=k)
    want = t2n(nchw(feats_w))
    np.testing.assert_allclose(t2n(feats), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    buffers = dict(port.named_buffers())
    for n, v in from_jax({"params": {}, "batch_stats": stats_w}, "fasterrcnn").items():
        np.testing.assert_allclose(buffers[n].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=n)
