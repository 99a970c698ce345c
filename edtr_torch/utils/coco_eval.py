"""COCO-style mAP evaluation in pure numpy (host-side).

Counterpart of ``edtr_tpu/utils/coco_eval.py``, copied; processes merge
their predictions over ``torch.distributed``.

Replaces the reference's pycocotools-backed ``CocoEvaluator``
(``utils/detection.py:422-616``) — pycocotools is not a dependency, so
the COCOeval bbox protocol is reimplemented: greedy per-class
matching in score order at IoU thresholds .5:.05:.95, area ranges
(all/small/medium/large), maxDets (1, 10, 100), 101-point interpolated AP,
with iscrowd handling. Evaluation stays off-device, mirroring the reference's
host-side design (SURVEY.md §7).

API shape mirrors the reference:
    ev = CocoEvaluator(gt_annots)          # {image_id: {boxes, labels, iscrowd, area}}
    ev.update({image_id: {boxes, scores, labels}})
    ev.synchronize_between_processes()     # multihost merge hook
    ev.accumulate(); ev.summarize()        # prints the 12 COCO metrics
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32 ** 2),
    "medium": (32 ** 2, 96 ** 2),
    "large": (96 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_matrix(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU with crowd semantics: for crowd gt, intersection over det area."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    lt = np.maximum(dt[:, None, :2], gt[None, :, :2])
    rb = np.minimum(dt[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = ((dt[:, 2] - dt[:, 0]) * (dt[:, 3] - dt[:, 1]))[:, None]
    area_g = ((gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1]))[None, :]
    union = np.where(iscrowd[None, :].astype(bool), area_d, area_d + area_g - inter)
    return inter / np.maximum(union, 1e-9)


class CocoEvaluator:
    def __init__(self, gt: Dict, iou_types: Sequence[str] = ("bbox",)):
        assert list(iou_types) == ["bbox"], "only bbox supported (reference parity)"
        self.gt = gt  # image_id -> dict(boxes (G,4), labels (G,), iscrowd, area)
        self.dt: Dict = {}
        cats = set()
        for ann in gt.values():
            cats.update(int(c) for c in np.asarray(ann["labels"]).ravel())
        self.cat_ids = sorted(cats) if cats else [1]

    def update(self, predictions: Dict) -> None:
        """predictions: image_id -> dict(boxes (D,4), scores (D,), labels (D,)),
        numpy arrays or tensors (copied to the host here)."""
        for img_id, pred in predictions.items():
            self.dt[img_id] = {
                "boxes": _host(pred["boxes"], np.float64).reshape(-1, 4),
                "scores": _host(pred["scores"], np.float64).ravel(),
                "labels": _host(pred["labels"], np.int64).ravel(),
            }

    @staticmethod
    def merge_prediction_shards(shards) -> Dict:
        """Merge per-process prediction dicts (last writer wins per image,
        matching the reference's dict.update over gathered objects)."""
        merged: Dict = {}
        for shard in shards:
            merged.update(shard)
        return merged

    def synchronize_between_processes(self) -> None:
        """Merge the processes' prediction dicts (the reference gathers them
        with ``dist.all_gather_object``, utils/detection.py:631-644); one
        process, or no process group, returns at once."""
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            return
        shards = [None] * dist.get_world_size()
        dist.all_gather_object(shards, self.dt)
        self.dt = self.merge_prediction_shards(shards)

    # -- evaluation -----------------------------------------------------------
    def accumulate(self) -> None:
        T, K = len(IOU_THRS), len(self.cat_ids)
        A, M = len(AREA_RNG), len(MAX_DETS)
        R = len(REC_THRS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        img_ids = sorted(self.gt.keys(), key=str)
        for k, cat in enumerate(self.cat_ids):
            # per-image matches for this category
            evals = [
                self._evaluate_img(img_id, cat) for img_id in img_ids
            ]
            for a, (aname, arng) in enumerate(AREA_RNG.items()):
                for m, max_det in enumerate(MAX_DETS):
                    stats = self._accumulate_cat(evals, arng, max_det)
                    if stats is None:
                        continue
                    tps, fps, scores, n_gt = stats
                    if n_gt == 0:
                        continue
                    order = np.argsort(-scores, kind="mergesort")
                    tps, fps = tps[:, order], fps[:, order]
                    tp_sum = np.cumsum(tps, axis=1)
                    fp_sum = np.cumsum(fps, axis=1)
                    for t in range(T):
                        tp, fp = tp_sum[t], fp_sum[t]
                        rc = tp / n_gt
                        pr = tp / np.maximum(tp + fp, 1e-9)
                        recall[t, k, a, m] = rc[-1] if len(rc) else 0
                        # precision envelope (monotone decreasing)
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(R)
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[t, :, k, a, m] = q
        self.precision = precision
        self.recall = recall

    def _evaluate_img(self, img_id, cat):
        g = self.gt[img_id]
        gmask = np.asarray(g["labels"]).ravel() == cat
        gboxes = np.asarray(g["boxes"], np.float64).reshape(-1, 4)[gmask]
        giscrowd = np.asarray(g.get("iscrowd", np.zeros(len(gboxes)))).ravel()[gmask]
        garea = np.asarray(
            g.get("area", (gboxes[:, 2] - gboxes[:, 0]) * (gboxes[:, 3] - gboxes[:, 1]))
        ).ravel()[gmask] if gmask.any() else np.zeros(0)

        d = self.dt.get(img_id, {"boxes": np.zeros((0, 4)), "scores": np.zeros(0), "labels": np.zeros(0, np.int64)})
        dmask = d["labels"] == cat
        dboxes = d["boxes"][dmask]
        dscores = d["scores"][dmask]
        order = np.argsort(-dscores, kind="mergesort")
        dboxes, dscores = dboxes[order], dscores[order]
        darea = (dboxes[:, 2] - dboxes[:, 0]) * (dboxes[:, 3] - dboxes[:, 1])

        iou = _iou_matrix(dboxes, gboxes, giscrowd)
        return dict(
            dscores=dscores, darea=darea, garea=garea,
            giscrowd=giscrowd.astype(bool), iou=iou,
        )

    def _accumulate_cat(self, evals, arng, max_det):
        T = len(IOU_THRS)
        all_tp, all_fp, all_scores = [], [], []
        n_gt = 0
        for ev in evals:
            g_ignore = (ev["garea"] < arng[0]) | (ev["garea"] > arng[1]) | ev["giscrowd"]
            n_gt += int((~g_ignore).sum())
            nd = min(len(ev["dscores"]), max_det)
            iou = ev["iou"][:nd]
            dscores = ev["dscores"][:nd]
            d_out_of_rng = (ev["darea"][:nd] < arng[0]) | (ev["darea"][:nd] > arng[1])
            ng = iou.shape[1]
            # pycocotools evaluateImg sorts gts ignore-LAST (stable), so the
            # break below never abandons a regular gt for an ignored one and a
            # det tentatively on an ignored gt can still claim a regular gt.
            gtind = np.argsort(g_ignore, kind="mergesort")
            g_ign_s = g_ignore[gtind]
            crowd_s = ev["giscrowd"][gtind]
            iou_s = iou[:, gtind]
            tp = np.zeros((T, nd))
            fp = np.zeros((T, nd))
            d_ignore_final = np.zeros((T, nd), bool)
            for t, thr in enumerate(IOU_THRS):
                taken = np.zeros(ng, bool)
                for di in range(nd):
                    best, best_g = min(thr, 1 - 1e-10), -1
                    for gi in range(ng):
                        if taken[gi] and not crowd_s[gi]:
                            continue
                        # sorted: once matched to a regular gt, all remaining
                        # gts are ignored -> stop
                        if best_g > -1 and not g_ign_s[best_g] and g_ign_s[gi]:
                            break
                        if iou_s[di, gi] < best:
                            continue
                        best, best_g = iou_s[di, gi], gi
                    if best_g == -1:
                        fp[t, di] = not d_out_of_rng[di]
                        continue
                    # pycocotools sets gtm for EVERY match (ignored or not);
                    # only crowd gts stay rematchable via the skip condition
                    taken[best_g] = True
                    if g_ign_s[best_g]:
                        d_ignore_final[t, di] = True  # matched to ignored gt
                    else:
                        tp[t, di] = 1
                # unmatched dets outside area range are ignored (not FP)
                fp[t] = (tp[t] == 0) & ~d_ignore_final[t] & ~d_out_of_rng
            all_tp.append(tp)
            all_fp.append(fp)
            all_scores.append(dscores)
        if not all_scores:
            return None
        return (
            np.concatenate(all_tp, axis=1),
            np.concatenate(all_fp, axis=1),
            np.concatenate(all_scores),
            n_gt,
        )

    def summarize(self, verbose: bool = True) -> Dict[str, float]:
        def _mean(x):
            x = x[x > -1]
            return float(x.mean()) if x.size else -1.0

        p, r = self.precision, self.recall
        a_all = list(AREA_RNG).index("all")
        m100 = MAX_DETS.index(100)
        stats = {
            "AP": _mean(p[:, :, :, a_all, m100]),
            "AP50": _mean(p[0, :, :, a_all, m100]),
            "AP75": _mean(p[5, :, :, a_all, m100]),
            "AP_small": _mean(p[:, :, :, list(AREA_RNG).index("small"), m100]),
            "AP_medium": _mean(p[:, :, :, list(AREA_RNG).index("medium"), m100]),
            "AP_large": _mean(p[:, :, :, list(AREA_RNG).index("large"), m100]),
            "AR1": _mean(r[:, :, a_all, 0]),
            "AR10": _mean(r[:, :, a_all, 1]),
            "AR100": _mean(r[:, :, a_all, m100]),
            "AR_small": _mean(r[:, :, list(AREA_RNG).index("small"), m100]),
            "AR_medium": _mean(r[:, :, list(AREA_RNG).index("medium"), m100]),
            "AR_large": _mean(r[:, :, list(AREA_RNG).index("large"), m100]),
        }
        if verbose:
            for k, v in stats.items():
                print(f"  {k:<10}= {v:.4f}")
        return stats


def _host(x, dtype) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)
