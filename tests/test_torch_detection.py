"""The port's detector (``edtr_torch.ops.{boxes,roi_align}``,
``edtr_torch.models.{mobilenetv3,faster_rcnn}``) against ``edtr_tpu`` on
the CPU, on the same numpy inputs and the same weights (the JAX variables
carried over by the bridge, ``from_jax(..., "fasterrcnn")``).

Box ops hold to 1e-6 in fp32; rankings and NMS keep masks are equal
exactly, ties, duplicate boxes and invalid entries included, at JAX's
dense (N <= 256) and bit-packed (N > 256) NMS sizes; RoIAlign holds to
1e-5 in fp32 and 2 bf16 ulps in bf16; modules and the tiny detector
(``__graft_entry__._tiny_detnet``'s knobs) to rtol = atol = 3e-3 in fp32,
their discrete outputs (valid, labels) equal. A discrete mismatch reports
the margins of the decisions it rests on (IoU against its threshold, score
gaps at the top-k edges). The ResNet50-FPN-v2 (the same knobs,
``backbone_type="resnet50_fpn_v2"``): the bridge's round trip exactly, its
FPN maps, objectness and deltas at 3e-3 of their largest value, proposals
and boxes at 1e-5, valid and labels exactly. The JAX side is built once per
module: one ``jax.jit`` per network."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as G
from edtr_tpu.models import faster_rcnn as JF
from edtr_tpu.models.mobilenetv3 import MobileNetV3 as JMobileNetV3
from edtr_tpu.ops import boxes as JB
from edtr_tpu.ops import roi_align as JR
from edtr_tpu.utils import convert as C
from edtr_torch.models import faster_rcnn as TF
from edtr_torch.models.mobilenetv3 import MobileNetV3
from edtr_torch.ops import boxes as TB
from edtr_torch.ops import roi_align as TR
from edtr_torch.utils.convert import from_jax
from torch_port_helpers import cheap_jit, nchw, nhwc, t2n


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=3e-3, atol=3e-3)
BOX_TOL = dict(rtol=1e-6, atol=1e-6)
DET_IMAGE = 128  # the tiny detector's input (4x4 FPN maps at stride 32)
DET_BATCH = 2


def _boxes(rng, n, size=100.0, dup=0):
    """n random boxes in [0, size]², the last ``dup`` copies of earlier ones."""
    xy = rng.random((n, 2)) * size
    wh = rng.random((n, 2)) * size / 3 + 1
    b = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    if dup:
        b[n - dup:] = b[rng.integers(0, n - dup, dup)]
    return b


def _t(a):
    return torch.from_numpy(np.array(a))


# -- box ops -----------------------------------------------------------------

def test_box_iou_clip_and_small_box_mask():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 50), _boxes(rng, 70)
    np.testing.assert_allclose(t2n(TB.box_iou(_t(a), _t(b))),
                               np.asarray(JB.box_iou(a, b)), **BOX_TOL)
    wide = (rng.standard_normal((40, 4)) * 80 + 30).astype(np.float32)
    np.testing.assert_array_equal(t2n(TB.clip_boxes_to_image(_t(wide), 48, 64)),
                                  np.asarray(JB.clip_boxes_to_image(wide, 48, 64)))
    small = np.concatenate([wide[:, :2], wide[:, :2] + rng.random((40, 2)) * 2e-2], 1)
    for boxes, min_size in ((small, 1e-2), (wide, 1e-3)):
        np.testing.assert_array_equal(
            TB.small_box_mask(_t(boxes.astype(np.float32)), min_size).numpy(),
            np.asarray(JB.small_box_mask(boxes.astype(np.float32), min_size)))


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_decode_boxes_with_the_clamp(weights):
    assert TB.BBOX_XFORM_CLIP == JB.BBOX_XFORM_CLIP
    rng = np.random.default_rng(1)
    props = _boxes(rng, 60)
    deltas = (rng.standard_normal((60, 3 * 4)) * 2).astype(np.float32)
    deltas[:10, 2::4] = 40.0  # past log(1000/16) * ww: the clamp decides
    deltas[10:20, 3::4] = 30.0
    got = t2n(TB.decode_boxes(_t(deltas), _t(props), weights))
    want = np.asarray(JB.decode_boxes(deltas, props, weights))
    assert got.shape == want.shape == (60, 3, 4)
    np.testing.assert_allclose(got, want, **BOX_TOL)


def _tied_rows(seed, rows, n, dup):
    """Rows of boxes with duplicates, scores on a coarse grid (many exact
    ties) and about a fifth invalid."""
    rng = np.random.default_rng(seed)
    boxes = np.stack([_boxes(rng, n, dup=dup) for _ in range(rows)])
    scores = (rng.integers(0, 12, (rows, n)) / 4.0).astype(np.float32)
    valid = rng.random((rows, n)) > 0.2
    return boxes, scores, valid


@pytest.mark.parametrize("n,k", [(64, 20), (300, 100), (1000, 1000)])
def test_top_k_by_score_equal_on_ties(n, k):
    _, scores, valid = _tied_rows(2, 3, n, 0)
    idx, iv = TB.top_k_by_score(_t(scores), k, _t(valid))
    j_idx, j_iv = cheap_jit(jax.vmap(lambda s, v: JB.top_k_by_score(s, k, v)))(scores, valid)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(iv.numpy(), np.asarray(j_iv))
    j_idx, _ = JB.top_k_by_score(scores[0], k)  # no validity mask
    np.testing.assert_array_equal(TB.top_k_by_score(_t(scores[0]), k)[0].numpy(),
                                  np.asarray(j_idx))


@pytest.mark.parametrize("n", [64, 300, 1000])
@pytest.mark.parametrize("thr", [0.5, 0.7])
def test_nms_mask_equal_on_ties_duplicates_and_invalid(n, thr):
    """Rows batched on each side (JAX: dense at N 64, bit-packed above 256,
    under ``vmap`` as its detector runs it); the same keep mask exactly,
    with suppressions in every row."""
    boxes, scores, valid = _tied_rows(3, 3, n, n // 8)
    TB.host_syncs.update(calls=0, syncs=0)
    keep = TB.nms_mask(_t(boxes), _t(scores), thr, _t(valid)).numpy()
    assert TB.host_syncs["calls"] == 1 and TB.host_syncs["syncs"] >= 1
    want = cheap_jit(jax.vmap(lambda b, s, v: JB.nms_mask(b, s, thr, v)))(boxes, scores, valid)
    np.testing.assert_array_equal(keep, np.asarray(want))
    assert not (keep & ~valid).any() and (keep.sum(1) < valid.sum(1)).all()
    want = cheap_jit(lambda b, s: JB.nms_mask(b, s, thr))(boxes[0], scores[0])  # no mask
    np.testing.assert_array_equal(TB.nms_mask(_t(boxes[0]), _t(scores[0]), thr).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("n", [64, 300])
def test_batched_nms_mask_equal_on_ties(n):
    boxes, scores, valid = _tied_rows(4, 1, n, n // 8)
    idxs = np.random.default_rng(5).integers(0, 4, n).astype(np.int32)
    got = TB.batched_nms_mask(_t(boxes[0]), _t(scores[0]), _t(idxs), 0.5, _t(valid[0]))
    want = JB.batched_nms_mask(boxes[0], scores[0], idxs, 0.5, valid[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- RoIAlign ------------------------------------------------------------------

def _bf16_ulps(got, want):
    """Elementwise |got - want| in bf16 ulps of the larger magnitude."""
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    return np.abs(got - want) / ulp


def _rois(rng, n, size):
    """RoIs over a size² image, some reaching past it by more than a bin."""
    b = _boxes(rng, n, size * 1.1)
    b[: n // 4] -= size * 0.2
    return b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align(dtype):
    rng = np.random.default_rng(6)
    feat = rng.standard_normal((2, 12, 10, 16)).astype(np.float32)  # NHWC
    rois = np.stack([_rois(rng, 30, 80.0) for _ in range(2)])
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = cheap_jit(jax.vmap(lambda f, r: JR.roi_align(f, r, 1 / 8, 7, 2)))(
        jnp.asarray(feat, jdt), rois)
    want = np.asarray(want.astype(jnp.float32))  # (B, N, S, S, C)
    got = TR.roi_align(nchw(feat).to(getattr(torch, dtype)), _t(rois), 1 / 8, 7, 2)
    got = t2n(got).transpose(0, 1, 3, 4, 2)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _bf16_ulps(got, want).max() <= 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scales", [(1 / 16, 1 / 32), (1 / 32, 1 / 32)])
def test_multiscale_roi_align(scales, dtype):
    """Levels picked by area (1/16, 1/32), and the MobileNet FPN's two maps
    at one scale, where every RoI pools from level 0."""
    rng = np.random.default_rng(7)
    size = 256.0
    feats = [rng.standard_normal((1, int(size * s), int(size * s), 8)).astype(np.float32)
             for s in scales]
    rois = _rois(rng, 40, size)
    rois[:10, 2:] = rois[:10, :2] + 300.0  # large: level 1 where it exists
    levels = TR.fpn_level_for_rois(_t(rois), 4, 5).numpy()
    np.testing.assert_array_equal(levels, np.asarray(JR.fpn_level_for_rois(rois, 4, 5)))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(JR.multiscale_roi_align([jnp.asarray(f[0], jdt) for f in feats], rois,
                                              scales).astype(jnp.float32))
    got = TR.multiscale_roi_align([nchw(f).to(getattr(torch, dtype)) for f in feats],
                                  _t(rois[None]), scales)
    got = t2n(got)[0].transpose(0, 2, 3, 1)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _bf16_ulps(got, want).max() <= 2


# -- weights -------------------------------------------------------------------

def _random_variables(shapes, seed):
    """A flax variables tree from numpy: kernels ~ N(0, 1/fan_in), norm
    scales 1 + N(0, 0.1²), biases and running means N(0, 0.1²), running
    variances 1."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(s.shape) * np.prod(s.shape[:-1]) ** -0.5
        if name == "var":
            return np.ones(s.shape)
        return (1.0 if name == "scale" else 0.0) + 0.1 * rng.standard_normal(s.shape)
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.tree_util.tree_map_with_path(leaf, shapes))


def _port_detector(dtype=None):
    return TF.fasterrcnn_mobilenet_v3_large_fpn(
        num_classes=6, dtype=dtype, device="cpu", min_size=DET_IMAGE,
        max_size=DET_IMAGE * 2, rpn_pre_nms_top_n_test=64, rpn_post_nms_top_n_test=32,
        box_detections_per_img=8)


@functools.lru_cache(maxsize=1)
def _detector():
    """(JAX tiny detector, its variables, the batch): random weights whose
    heads are scaled to unit output RMS on the batch in the port
    (``calibrate_heads_``), then carried back to JAX by its own converter,
    so the heads' features are O(1) and class scores pass the threshold."""
    det = G._tiny_detnet(DET_IMAGE)
    shapes = jax.eval_shape(
        lambda k: det.init({"params": k}, jnp.zeros((1, DET_IMAGE, DET_IMAGE, 3))),
        jax.random.PRNGKey(0))
    images = np.random.default_rng(8).random(
        (DET_BATCH, DET_IMAGE, DET_IMAGE, 3)).astype(np.float32)
    port = _port_detector()
    port.load_state_dict(from_jax(_random_variables(shapes, 9), "fasterrcnn"), strict=True)
    TF.calibrate_heads_(port, nchw(images))
    variables = C.convert_fasterrcnn_mobilenet(
        {k: v.numpy() for k, v in port.state_dict().items()})
    return det, variables, images


@functools.lru_cache(maxsize=1)
def _jax_detect():
    det, variables, images = _detector()
    fn = cheap_jit(lambda v, x, mp: det.apply(v, x, manual_proposals=mp))
    plain = cheap_jit(lambda v, x: det.apply(v, x))
    return plain(variables, images), fn


def _port_loaded(dtype=None):
    _, variables, _ = _detector()
    port = _port_detector(dtype)
    port.load_state_dict(from_jax(variables, "fasterrcnn"), strict=True)
    return port


# -- modules -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mobilenetv3_features_full_width(dtype):
    """All 17 stage outputs on a 64² input: fp32 at the module tolerance;
    bf16 reported (relative L2 of each stage against JAX's bf16 net)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    net = JMobileNetV3(dtype=jdt)
    x = np.random.default_rng(10).random((2, 64, 64, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda k: net.init(k, jnp.zeros((1, 64, 64, 3)), features=True),
                            jax.random.PRNGKey(0))
    variables = _random_variables(shapes, 11)
    want = cheap_jit(lambda v, x: net.apply(v, x, features=True))(variables, x)
    port = MobileNetV3(dtype=getattr(torch, dtype) if jdt else None)
    port.load_state_dict(from_jax(variables, "mobilenetv3"), strict=True)
    assert port.stage_indices() == net.stage_indices() == [0, 2, 4, 7, 13, 16]
    assert port.stage_channels() == net.stage_channels()
    with torch.no_grad():
        got = port(nchw(x))
    assert len(got) == len(want) == 17
    rel = []
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32  # the norms' dtype, as in JAX
        if jdt is None:
            np.testing.assert_allclose(nhwc(g), w, err_msg=f"stage {i}", **TOL)
        rel.append(float(np.linalg.norm(nhwc(g) - w) / np.linalg.norm(w)))
    print(f"mobilenetv3 {dtype}: relative L2 by stage vs JAX {rel}")
    assert all(np.isfinite(rel))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(4, 4), (7, 5)])
def test_fpn_and_rpn_head(hw, dtype):
    """The FPN (top-down over equal maps as the MobileNet gives them, and a
    coarser top map) and the RPN head, on one set of weights: fp32 at the
    module tolerance; bf16 reported (relative L2 against JAX's bf16 heads)."""
    rng = np.random.default_rng(12)
    top = hw if hw == (4, 4) else (4, 3)
    c4 = rng.standard_normal((2, *hw, 160)).astype(np.float32)
    c5 = rng.standard_normal((2, *top, 960)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    fpn = JF.FeaturePyramidNetwork(out_channels=256, num_levels=2, dtype=jdt)
    head = JF.RPNHead(num_anchors=15, dtype=jdt)
    fp = _random_variables(jax.eval_shape(fpn.init, jax.random.PRNGKey(0), [c4, c5]), 13)
    want = fpn.apply(fp, [c4, c5])
    hp = _random_variables(jax.eval_shape(head.init, jax.random.PRNGKey(0), want), 14)
    want_obj, want_dlt = head.apply(hp, want)
    tdt = getattr(torch, dtype) if jdt else None
    port_fpn, port_head = TF.FeaturePyramidNetwork([160, 960], dtype=tdt), TF.RPNHead(256, 15, tdt)
    sd = from_jax({"params": {"fpn": fp["params"], "rpn_head": hp["params"]},
                   "batch_stats": {}}, "fasterrcnn")
    port_fpn.load_state_dict({k[len("backbone.fpn."):]: v for k, v in sd.items()
                              if k.startswith("backbone.fpn.")}, strict=True)
    port_head.load_state_dict({k[len("rpn.head."):]: v for k, v in sd.items()
                               if k.startswith("rpn.head.")}, strict=True)
    with torch.no_grad():
        got = port_fpn([nchw(c4), nchw(c5)])
        got_obj, got_dlt = port_head(got)
    rel = []
    for g, wnt in zip(got + got_obj + got_dlt, list(want) + want_obj + want_dlt):
        wnt = np.asarray(wnt, np.float32)
        if jdt is None:
            np.testing.assert_allclose(nhwc(g), wnt, **TOL)
        rel.append(float(np.linalg.norm(nhwc(g) - wnt) / np.linalg.norm(wnt)))
    print(f"fpn + rpn head {dtype}: relative L2 vs JAX (3 maps, 3 objectness, 3 deltas) {rel}")
    assert all(np.isfinite(rel))


def test_anchors_equal():
    shapes, strides = [(25, 25), (25, 25), (13, 13)], [(32, 32), (32, 32), (61, 61)]
    sizes, ratios = ((32, 64, 128, 256, 512),) * 3, ((0.5, 1.0, 2.0),) * 3
    want = JF.generate_anchors(shapes, strides, sizes, ratios)
    got = TF.generate_anchors(shapes, strides, sizes, ratios)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    port = _port_loaded()
    cached = port.anchors(shapes, strides, torch.device("cpu"))
    assert port.anchors(shapes, strides, torch.device("cpu")) is cached  # made once
    for g, w in zip(cached, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("size", [64, 128])
def test_transform_resize_up_and_down(size):
    """64 -> 96 upsamples (plain bilinear), 128 -> 96 shrinks (antialiased),
    both against JAX's ``jax.image.resize``; normalised first, padded to a
    multiple of 32, as ``RCNNTransform`` orders them."""
    x = np.random.default_rng(15).random((2, size, size + 16, 3)).astype(np.float32)
    jt = JF.RCNNTransform(min_size=96, max_size=400)
    want, _, want_hw, want_scale = jt.resize(jt.normalize(jnp.asarray(x)))
    tt = TF.RCNNTransform(min_size=96, max_size=400)
    got, hw, scale = tt.resize(tt.normalize(nchw(x)))
    assert (hw, scale) == (want_hw, want_scale)
    assert nhwc(got).shape == np.asarray(want).shape
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


# -- the tiny detector end to end -----------------------------------------------

def _margins(port, feats, dets):
    """The margins of the port's discrete decisions: the smallest score gap
    at a top-k edge (RPN pre-NMS per level, detections per image), the
    smallest |IoU - threshold| among valid candidates of one NMS row (RPN
    levels, box-head classes), and the smallest |score - threshold|."""
    gaps, ious = [], []
    k = port.rpn_pre_nms_top_n["test"]
    for obj in feats["objectness"]:
        s = torch.sort(TF._nhwc_flat(obj, 1)[..., 0], descending=True).values
        if s.shape[1] > k:
            gaps.append((s[:, k - 1] - s[:, k]).abs().min().item())
    scores = torch.softmax(feats["class_logits"], -1)[..., 1:].transpose(1, 2)
    flat = torch.sort(scores.flatten(1), descending=True).values
    d = port.box_detections_per_img
    gaps.append((flat[:, d - 1] - flat[:, d]).abs().min().item())
    props = feats["proposals"]
    iou = TB.box_iou(props, props)
    ious.append((iou - port.rpn_nms_thresh).abs().min().item())
    score_gap = (scores - port.box_score_thresh).abs().min().item()
    return dict(topk_score_gap=min(gaps), iou_minus_threshold=min(ious),
                score_minus_threshold=score_gap, port_scores=dets["scores"].numpy().tolist())


def _check_detections(port, feats, got, want):
    msg = f"a discrete decision flipped; margins {_margins(port, feats, got)}"
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]), msg)
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]), msg)
    wv = np.asarray(want["valid"])
    assert wv.any() and len(np.unique(np.asarray(want["labels"])[wv])) >= 2
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), **TOL)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), **TOL)


def test_tiny_detector_matches_jax():
    """FPN maps, objectness and deltas at the module tolerance; the
    detections' valid and labels equal, boxes and scores at 3e-3."""
    (want, _, wfeats), _ = _jax_detect()
    _, _, images = _detector()
    port = _port_loaded()
    with torch.no_grad():
        got, losses, feats = port(nchw(images))
    assert losses == {}
    for name in ("0", "1", "pool"):
        np.testing.assert_allclose(nhwc(feats["features"][name]),
                                   np.asarray(wfeats["features"][name]), err_msg=name, **TOL)
    for key in ("objectness", "pred_bbox_deltas"):
        for g, w in zip(feats[key], wfeats[key]):
            np.testing.assert_allclose(nhwc(g), np.asarray(w), err_msg=key, **TOL)
    np.testing.assert_allclose(t2n(feats["proposals"]), np.asarray(wfeats["proposals"]), **TOL)
    _check_detections(port, feats, got, want)


def test_tiny_detector_on_jax_proposals():
    """JAX's proposals (some marked invalid) through ``manual_proposals`` on
    both sides: the box head and post-processing alone."""
    (_, _, wfeats), fn = _jax_detect()
    _, variables, images = _detector()
    props = np.asarray(wfeats["proposals"])
    valid = np.random.default_rng(16).random(props.shape[:2]) > 0.25
    want, _, _ = fn(variables, images, (props, valid))
    port = _port_loaded()
    with torch.no_grad():
        got, _, feats = port(nchw(images), manual_proposals=(_t(props), _t(valid)))
    np.testing.assert_array_equal(t2n(feats["proposals"]), props)
    _check_detections(port, feats, got, want)


def test_detector_contract(monkeypatch):
    """Targets train: the four losses of JAX's detector come back, finite,
    and no detections; the factory's MobileNet settings, ``norm_frozen``,
    and its refusal of named weights and of the unported knob; the outputs'
    static shapes; no card and no device raises."""
    port = _port_loaded()
    assert port.rpn_score_thresh == 0.05 and port.norm_frozen is False
    assert TF.fasterrcnn_mobilenet_v3_large_fpn(norm_frozen=True, num_classes=21,
                                                device="cpu").norm_frozen
    for named in (dict(weights="coco"), dict(weights_backbone="imagenet")):
        with pytest.raises(ValueError, match="from_jax"):  # never random weights asked for
            TF.fasterrcnn_mobilenet_v3_large_fpn(device="cpu", **named)
    with pytest.raises(TypeError):  # not ported, never dropped silently
        TF.fasterrcnn_mobilenet_v3_large_fpn(device="cpu", box_pre_nms_top_n=100)
    x = torch.rand(1, 3, DET_IMAGE, DET_IMAGE)
    targets = dict(boxes=torch.tensor([[[8.0, 8.0, 60.0, 70.0], [0.0, 0.0, 0.0, 0.0]]]),
                   labels=torch.tensor([[2, 0]]), valid=torch.tensor([[True, False]]))
    dets, losses, _ = port(x, targets=targets, generator=torch.Generator().manual_seed(0))
    assert dets == {} and set(losses) == {"loss_objectness", "loss_rpn_box_reg",
                                          "loss_classifier", "loss_box_reg"}
    assert all(bool(torch.isfinite(v)) and v.requires_grad for v in losses.values())
    with torch.no_grad():
        dets, _, feats = port(x)
    assert dets["boxes"].shape == (1, 8, 4) and dets["valid"].dtype == torch.bool
    assert feats["proposals"].shape == (1, 32, 4)
    assert feats["class_logits"].shape == (1, 32, 6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TF.fasterrcnn_mobilenet_v3_large_fpn(num_classes=21)


# -- the ResNet50-FPN-v2 variant --------------------------------------------------

def _port_detector_v2(dtype=None, **kw):
    return TF.fasterrcnn_resnet50_fpn_v2(
        num_classes=6, dtype=dtype, device="cpu", min_size=DET_IMAGE,
        max_size=DET_IMAGE * 2, rpn_pre_nms_top_n_test=64, rpn_post_nms_top_n_test=32,
        rpn_score_thresh=0.05, box_detections_per_img=8, **kw)


@functools.lru_cache(maxsize=1)
def _detector_v2():
    """The tiny v2 detector (``_tiny_detnet``'s knobs, ``backbone_type=
    "resnet50_fpn_v2"``, full width), its variables and the batch, as
    :func:`_detector` makes them: random weights, the heads calibrated in
    the port, carried back by JAX's ``convert_fasterrcnn_resnet50_v2``."""
    det = G._tiny_detnet(DET_IMAGE).clone(backbone_type="resnet50_fpn_v2")
    shapes = jax.eval_shape(
        lambda k: det.init({"params": k}, jnp.zeros((1, DET_IMAGE, DET_IMAGE, 3))),
        jax.random.PRNGKey(0))
    _, _, images = _detector()
    port = _port_detector_v2()
    port.load_state_dict(from_jax(_random_variables(shapes, 19), "fasterrcnn"), strict=True)
    TF.calibrate_heads_(port, nchw(images))
    variables = C.convert_fasterrcnn_resnet50_v2(
        {k: v.numpy() for k, v in port.state_dict().items()})
    return det, variables, images


@functools.lru_cache(maxsize=1)
def _jax_detect_v2():
    det, variables, images = _detector_v2()
    return cheap_jit(lambda v, x: det.apply(v, x))(variables, images)


def _port_loaded_v2():
    port = _port_detector_v2()
    port.load_state_dict(from_jax(_detector_v2()[1], "fasterrcnn"), strict=True)
    return port


def test_v2_bridge_round_trip():
    """The port's v2 state dict through JAX's converter and back through
    ``from_jax`` is itself, key for key (loaded strictly)."""
    port = _port_loaded_v2()
    back = from_jax(C.convert_fasterrcnn_resnet50_v2(
        {k: v.numpy() for k, v in port.state_dict().items()}), "fasterrcnn")
    sd = port.state_dict()
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    assert any(k.startswith("roi_heads.box_head.5.") for k in sd)
    assert "backbone.fpn.inner_blocks.3.1.running_var" in sd


def test_tiny_v2_detector_matches_jax():
    """FPN maps (five), objectness and deltas at 3e-3 of their largest
    value; proposals, detections' valid and labels equal; boxes at 1e-5."""
    want, _, wfeats = _jax_detect_v2()
    _, _, images = _detector_v2()
    port = _port_loaded_v2()
    with torch.no_grad():
        got, _, feats = port(nchw(images))
    assert port.feature_names == ("0", "1", "2", "3", "pool")
    for name in port.feature_names:
        w = np.asarray(wfeats["features"][name])
        np.testing.assert_allclose(nhwc(feats["features"][name]), w, rtol=3e-3,
                                   atol=3e-3 * np.abs(w).max(), err_msg=name)
    for key in ("objectness", "pred_bbox_deltas"):
        assert len(feats[key]) == len(wfeats[key]) == 5
        for g, w in zip(feats[key], wfeats[key]):
            w = np.asarray(w)
            np.testing.assert_allclose(nhwc(g), w, rtol=3e-3, atol=3e-3 * np.abs(w).max(),
                                       err_msg=key)
    msg = f"a discrete decision flipped; margins {_margins(port, feats, got)}"
    np.testing.assert_allclose(t2n(feats["proposals"]), np.asarray(wfeats["proposals"]),
                               rtol=1e-5, atol=1e-5 * DET_IMAGE, err_msg=msg)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]), msg)
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]), msg)
    assert np.asarray(want["valid"]).any()
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=1e-5,
                               atol=1e-5 * DET_IMAGE)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), **TOL)


def test_v2_factory_contract(monkeypatch):
    """The v2 factory: JAX's defaults (norms never frozen, 91 classes, the
    two-conv RPN head, one anchor size a level), ``weights_backbone``
    accepted and ignored as JAX's factory does, the whole detector's
    ``weights`` refused; the MobileNet detector's fields otherwise."""
    port = TF.fasterrcnn_resnet50_fpn_v2(weights_backbone="ResNet50_Weights.IMAGENET1K_V2",
                                         device="cpu")
    assert port.norm_frozen is False and port.num_classes == 91
    assert port.backbone_type == "resnet50_fpn_v2" and len(port.rpn.head.conv) == 2
    assert port.anchor_sizes == ((32,), (64,), (128,), (256,), (512,)) and port.num_anchors == 3
    assert sum(p.numel() for p in port.parameters()) == 43712278  # torchvision's v2
    with pytest.raises(ValueError, match="from_jax"):
        TF.fasterrcnn_resnet50_fpn_v2(weights="coco", device="cpu")
    with pytest.raises(ValueError, match="backbone_type"):
        TF.FasterRCNN(backbone_type="resnet101")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TF.fasterrcnn_resnet50_fpn_v2()
