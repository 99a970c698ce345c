"""The port's task metrics and COCO evaluator (``edtr_torch.utils.metrics``,
``edtr_torch.utils.coco_eval``) against ``edtr_tpu``'s on the same seeded
inputs, on the CPU:

* ``topk_accuracy`` (a stable sort of ``-logits``, so tied logits rank in
  index order as ``jnp.argsort``'s do), ``confusion_matrix`` (``bincount``
  with the 255 border left out) and ``compute_iou``: exact;
* ``CocoEvaluator``'s 12 stats on seeded scenes (several classes, crowd
  boxes, small/medium/large areas, empty images, more detections than
  ``maxDets``): exact; tensor predictions are taken as numpy ones;
  ``synchronize_between_processes`` at one process returns, and the shards'
  merge is JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edtr_tpu.utils import coco_eval as JE
from edtr_tpu.utils import metrics as JM
from edtr_torch.utils import coco_eval as TE
from edtr_torch.utils import metrics as TM


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("ties", [False, True])
def test_topk_accuracy_matches_jax(ties):
    g = np.random.default_rng(3)
    logits = g.standard_normal((16, 10)).astype(np.float32)
    if ties:  # whole rows of equal logits and a quantised grid of values
        logits = np.round(logits * 2) / 2
        logits[:4] = 0.5
    labels = g.integers(0, 10, 16).astype(np.int32)
    topk = (1, 3, 5)
    got = TM.topk_accuracy(torch.from_numpy(logits), torch.from_numpy(labels).long(), topk)
    want = JM.topk_accuracy(jnp.asarray(logits), jnp.asarray(labels), topk)
    assert [int(v) for v in got] == [int(v) for v in want]


@pytest.mark.parametrize("num_classes", [3, 21])
def test_confusion_matrix_and_iou_match_jax(num_classes):
    g = np.random.default_rng(num_classes)
    target = g.integers(0, num_classes, (2, 40, 48)).astype(np.uint8)
    target[:, :3] = target[:, :, -2:] = 255  # the ignored border
    pred = g.integers(0, num_classes, (2, 40, 48)).astype(np.int64)
    got = TM.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(target), num_classes)
    want = JM.confusion_matrix(pred, target, num_classes)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    iou_t, miou_t = TM.compute_iou(got)
    iou_j, miou_j = JM.compute_iou(want)
    np.testing.assert_array_equal(iou_t.numpy(), iou_j)
    assert miou_t == miou_j


def _scene(seed: int, n_img: int = 6, n_cls: int = 4):
    """Seeded GT and predictions: jittered copies of the GT boxes, false
    positives, missed boxes, a crowd box, an image without GT, and one
    image with more detections than the largest ``maxDets``."""
    g = np.random.default_rng(seed)
    gt, dt = {}, {}
    for i in range(n_img):
        n = 0 if i == n_img - 1 else int(g.integers(1, 6))
        wh = g.choice([12.0, 50.0, 140.0], size=(n, 1)) * g.uniform(0.8, 1.2, (n, 2))
        xy = g.uniform(0, 300, (n, 2))
        boxes = np.concatenate([xy, xy + wh], 1)
        labels = g.integers(1, n_cls + 1, n)
        iscrowd = np.zeros(n, np.int64)
        if i == 1 and n:
            iscrowd[0] = 1
        gt[i] = dict(boxes=boxes, labels=labels, iscrowd=iscrowd,
                     area=(boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))
        keep = g.random(n) < 0.8
        det = boxes[keep] + g.normal(0, 4, (int(keep.sum()), 4))
        det_labels = labels[keep]
        m = 120 if i == 0 else int(g.integers(0, 4))
        fp_xy = g.uniform(0, 300, (m, 2))
        det = np.concatenate([det, np.concatenate([fp_xy, fp_xy + 30], 1)])
        det_labels = np.concatenate([det_labels, g.integers(1, n_cls + 1, m)])
        dt[i] = dict(boxes=det, scores=np.round(g.random(len(det)), 2), labels=det_labels)
    return gt, dt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_evaluator_stats_match_jax(seed):
    gt, dt = _scene(seed)
    ev_j = JE.CocoEvaluator(gt)
    ev_j.update(dt)
    ev_j.accumulate()
    want = ev_j.summarize(verbose=False)
    ev_t = TE.CocoEvaluator(gt)
    ev_t.update({k: {n: torch.from_numpy(np.asarray(v)) for n, v in d.items()}
                 for k, d in dt.items()})
    ev_t.synchronize_between_processes()  # one process: a no-op
    ev_t.accumulate()
    got = ev_t.summarize(verbose=False)
    assert list(got) == list(want) and len(got) == 12
    assert got == want
    np.testing.assert_array_equal(ev_t.precision, ev_j.precision)
    np.testing.assert_array_equal(ev_t.recall, ev_j.recall)


def test_merge_prediction_shards_matches_jax():
    _, dt = _scene(4)
    shards = [{k: v for k, v in dt.items() if k % 2 == r} for r in range(2)]
    shards.append({0: dt[1]})  # a later shard wins for an image it repeats
    got = TE.CocoEvaluator.merge_prediction_shards(shards)
    want = JE.CocoEvaluator.merge_prediction_shards(shards)
    assert list(got) == list(want) and all(got[k] is want[k] for k in want)
