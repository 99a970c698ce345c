"""The port's host data path (``edtr_torch.data`` datasets, ``voc``,
``coco``, ``coco_mask``, ``augment``, ``val_data_generation``, and
``edtr_torch.train.harness``) against ``edtr_tpu``'s on small synthetic
VOC, COCO and image-folder trees written to ``tmp_path``
(``edtr_torch.data.synthetic``), on the CPU. Everything is exact:

* ``augment`` and the crops, VOC XML parsing and its COCO conversion, the
  COCO index and annotation conversion, polygon rasterisation and the RLE
  round trips;
* every dataset's ``__getitem__`` (``(gt, lq, annot, path)``, the COCO v2
  kernels), Python's ``random`` and numpy's global state seeded alike
  before each item on both sides, and the CodeFormer generator the same
  seeded ``Generator`` on both sides (JAX's ``np.random.default_rng``
  patched, the port's ``degradation.default_rng``);
* ``gt_from_dataset``; ``list_to_batch``, ``batch_to_list``, ``pad_annots``,
  ``collate_fn`` and the CodeFormer branch of ``prepare_batch``; the batch
  orders of ``make_dataloader`` (shuffled, aspect-ratio grouped, sharded
  over two processes) and of ``GroupedBatchSampler``.

The repair: ``val_data_generation`` twice with one seed writes the same
files in the port; JAX's writes different LQ images, because its
CodeFormer generator is ``np.random.default_rng()``, which no seed reaches.
"""

import contextlib
import os
import random
import xml.etree.ElementTree as ET
from unittest import mock

import numpy as np
import pytest
import torch
import yaml

from edtr_tpu.data import augment as JA
from edtr_tpu.data import coco as JCO
from edtr_tpu.data import coco_mask as JCM
from edtr_tpu.data import val_data_generation as JV
from edtr_tpu.data import voc as JVOC
from edtr_tpu.train import harness as JH
from edtr_torch.data import augment as TA
from edtr_torch.data import coco as TCO
from edtr_torch.data import coco_mask as TCM
from edtr_torch.data import degradation as TDg
from edtr_torch.data import synthetic as S
from edtr_torch.data import val_data_generation as TV
from edtr_torch.data import voc as TVOC
from edtr_torch.train import harness as TH

BACKEND = {"target": "datasets.file_backend.HardDiskBackend"}
CODEFORMER = dict(blur_kernel_size=21, kernel_list=["iso", "aniso"], kernel_prob=[0.5, 0.5],
                  blur_sigma=[0.1, 8], downsample_range=[1, 4], noise_range=[0, 10],
                  jpeg_range=[50, 100])
REAL_ESRGAN = dict(
    blur_kernel_size=21,
    kernel_list=["iso", "aniso", "generalized_iso", "generalized_aniso", "plateau_iso",
                 "plateau_aniso"],
    kernel_prob=[0.45, 0.25, 0.12, 0.03, 0.12, 0.03], sinc_prob=0.1, blur_sigma=[0.2, 3],
    betag_range=[0.5, 4], betap_range=[1, 2], blur_kernel_size2=21,
    kernel_list2=["iso", "aniso", "generalized_iso", "generalized_aniso", "plateau_iso",
                  "plateau_aniso"],
    kernel_prob2=[0.45, 0.25, 0.12, 0.03, 0.12, 0.03], sinc_prob2=0.5, blur_sigma2=[0.2, 1.5],
    betag_range2=[0.5, 4], betap_range2=[1, 2], final_sinc_prob=0.8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Synthetic VOC, COCO (train, val) and image-folder trees, and the
    port's degraded VOC pairs (det at 96, seg) and COCO pairs."""
    root = tmp_path_factory.mktemp("data")
    voc = S.write_voc_tree(str(root / "VOC"), n=5, seed=1)
    coco = str(root / "COCO")
    S.write_coco_tree(coco, n=5, split="train", seed=2)
    S.write_coco_tree(coco, n=4, split="val", seed=3)
    cub = S.write_image_folder(str(root / "CUB" / "train"), seed=4)
    for sub, seed in (("gt", 5), ("lq", 6)):
        S.write_image_folder(str(root / "CUB" / "val-deg" / sub), seed=seed)
    for task, target, extra in (
            ("det", "datasets.detection.DegradedDetectionDataset",
             dict(gt_size=96, out_size=96, crop_type="none")),
            ("seg", "datasets.segmentation.DegradedSegmentationDataset",
             dict(gt_size=64, resize_range=None, out_size=None, crop_type="none"))):
        cfg = _config(root / f"gen_{task}.yaml", target, voc,
                      dict(extra, hflip=False, rotation=False, image_set="val", **CODEFORMER))
        TV.generate(cfg, task, seed=231)
    for sub in ("gt", "lq"):
        os.makedirs(os.path.join(coco, "val2017-deg", sub))
        for name in sorted(os.listdir(os.path.join(coco, "val2017"))):
            img = np.asarray(_pil_open(os.path.join(coco, "val2017", name)))
            _pil_save(img[::2, ::2], os.path.join(coco, "val2017-deg", sub,
                                                  name.replace(".jpg", ".png")))
    return dict(voc=voc, coco=coco, cub=cub, cub_val=str(root / "CUB" / "val-deg"),
                root=str(root))


def _pil_open(path):
    from PIL import Image

    return Image.open(path).convert("RGB")


def _pil_save(arr, path):
    from PIL import Image

    Image.fromarray(arr).save(path)


def _config(path, target, root, params) -> str:
    cfg = {"dataset": {"train": {"target": target, "params": dict(
        root=root, file_backend_cfg=BACKEND, **params)}}}
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@contextlib.contextmanager
def _seeded(seed: int, side: str):
    """Python's and numpy's global generators seeded with ``seed`` and the
    CodeFormer generator a ``Generator`` seeded with it, on ``side``."""
    random.seed(seed)
    np.random.seed(seed)
    gen = np.random.default_rng(seed)
    if side == "jax":
        with mock.patch("numpy.random.default_rng", lambda *a, **k: gen):
            yield
    else:
        with mock.patch.object(TDg, "default_rng", lambda: gen):
            yield


def _assert_same(a, b, where=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, (where, a.dtype, b)
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b and type(a) is type(b), (where, a, b)


# -- host copies -------------------------------------------------------------------

def test_augment_and_crops_match_jax():
    g = np.random.default_rng(0)
    arrs = [g.random((12, 10, 3)).astype(np.float32), g.integers(0, 255, (12, 10), np.uint8)]
    for seed in range(8):
        for hflip, rotation in ((True, True), (True, False), (False, True)):
            outs = []
            for mod in (JA, TA):
                r = random.Random(seed)
                outs.append(mod.augment(list(arrs), hflip, rotation, return_status=True, rng=r))
            _assert_same(outs[0], outs[1])
        want = JA.random_crop_arr(arrs[0], 8, True, rng=random.Random(seed))
        _assert_same(TA.random_crop_arr(arrs[0], 8, True, rng=random.Random(seed)), want)
        _assert_same(TA.random_crop_arr(arrs[1], 8, crop_pos=want[1]),
                     JA.random_crop_arr(arrs[1], 8, crop_pos=want[1]))
    _assert_same(TA.center_crop_arr(arrs[0], 7, True), JA.center_crop_arr(arrs[0], 7, True))


def test_voc_parsing_matches_jax(trees):
    for task in ("detection", "segmentation"):
        _assert_same(TVOC.voc_file_lists(trees["voc"], "2012", "val", task),
                     JVOC.voc_file_lists(trees["voc"], "2012", "val", task))
    assert TVOC.get_label2id() == JVOC.get_label2id()
    for path in TVOC.voc_file_lists(trees["voc"], "2012", "val", "detection")[1]:
        node = ET.parse(path).getroot()
        parsed = TVOC.parse_voc_xml(node)
        assert parsed == JVOC.parse_voc_xml(node)
        _assert_same(TVOC.convert2coco(parsed, TVOC.get_label2id()),
                     JVOC.convert2coco(parsed, JVOC.get_label2id()))


def test_coco_masks_and_rle_match_jax():
    g = np.random.default_rng(7)
    h, w = 37, 53
    for _ in range(6):
        xy = g.uniform(-3, 56, 2 * int(g.integers(3, 8))).tolist()
        rle = TCM.poly_to_rle(xy, h, w)
        assert rle == JCM.poly_to_rle(xy, h, w)
        mask = TCM.rle_decode(rle)
        np.testing.assert_array_equal(mask, JCM.rle_decode(rle))
        enc = TCM.rle_encode_mask(mask)
        assert enc == JCM.rle_encode_mask(mask)
        comp = TCM.rle_compress(enc["counts"])
        assert comp == JCM.rle_compress(enc["counts"])
        assert TCM.rle_decompress(comp) == enc["counts"] == JCM.rle_decompress(comp)
        assert TCM.rle_area(enc) == JCM.rle_area(enc)
        assert TCM.rle_to_bbox(enc) == JCM.rle_to_bbox(enc)
    segms = [[g.uniform(0, 50, 8).tolist()], [g.uniform(0, 50, 6).tolist()] * 2,
             {"size": [h, w], "counts": [100, 30, h * w - 130]}]
    np.testing.assert_array_equal(TCM.convert_coco_poly_to_mask(segms, h, w),
                                  JCM.convert_coco_poly_to_mask(segms, h, w))
    assert TCM.rle_merge([TCM.poly_to_rle(s[0], h, w) for s in segms[:2]]) == \
        JCM.rle_merge([JCM.poly_to_rle(s[0], h, w) for s in segms[:2]])


def test_coco_index_and_annotations_match_jax(trees):
    ann = os.path.join(trees["coco"], "annotations", "instances_train2017.json")
    t, j = TCO.COCOIndex(ann), JCO.COCOIndex(ann)
    assert t.getImgIds() == j.getImgIds() and t.dataset == j.dataset
    for img_id in t.getImgIds():
        assert t.getAnnIds(img_id) == j.getAnnIds(img_id)
        anns = t.loadAnns(t.getAnnIds(img_id))
        assert anns == j.loadAnns(j.getAnnIds(img_id))
        info = t.loadImgs(img_id)[0]
        _assert_same(TCO.convert_coco_annotations(anns, info["height"], info["width"]),
                     JCO.convert_coco_annotations(anns, info["height"], info["width"]))
    _assert_same(TCO.gt_from_coco_index(t), JCO.gt_from_coco_index(j))


# -- datasets ------------------------------------------------------------------------

def _dataset_params(kind: str, trees) -> tuple:
    """(reference target, params) of each dataset on the synthetic trees."""
    voc, coco = trees["voc"], trees["coco"]
    return {
        "cls_degraded": ("datasets.classification.DegradedClassificationDataset",
                         dict(root=trees["cub"], gt_size=72, out_size=64, crop_type="random",
                              hflip=True, rotation=True, **CODEFORMER)),
        "cls_paired": ("datasets.classification.PairedClassificationDataset",
                       dict(root=trees["cub_val"])),
        "seg_degraded": ("datasets.segmentation.DegradedSegmentationDataset",
                         dict(root=voc, gt_size=64, resize_range=[0.75, 1.25], out_size=64,
                              crop_type="random", hflip=True, rotation=False, **CODEFORMER)),
        "seg_paired": ("datasets.segmentation.PairedSegmentationDataset",
                       dict(root=voc, path="JPEGImagesSeg-deg", gt_size=64)),
        "det_degraded": ("datasets.detection.DegradedDetectionDataset",
                         dict(root=voc, gt_size=96, out_size=48, crop_type="random",
                              hflip=True, rotation=False, **CODEFORMER)),
        "det_paired": ("datasets.detection.PairedDetectionDataset",
                       dict(root=voc, path="JPEGImagesDet-deg", gt_size=96)),
        "det_realworld": ("datasets.detection.RealworldDetectionDataset",
                          dict(root=os.path.join(voc, "VOCdevkit", "VOC2012", "JPEGImages"),
                               gt_size=80)),
        "coco_degraded": ("datasets.detection_coco.DegradedDetectionDatasetCoco",
                          dict(root=coco, gt_size=80, out_size=80, crop_type="none",
                               hflip=True, rotation=False, **CODEFORMER)),
        "coco_paired": ("datasets.detection_coco.PairedDetectionDatasetCoco",
                        dict(root=coco, path="val2017-deg", gt_size=80)),
        "cocov2": ("datasets.detection_cocov2.DegradedDetectionDatasetCocov2",
                   dict(root=coco, gt_size=80, out_size=80, crop_type="none", hflip=True,
                        rotation=False, **REAL_ESRGAN)),
    }[kind]


DATASETS = ["cls_degraded", "cls_paired", "seg_degraded", "seg_paired", "det_degraded",
            "det_paired", "det_realworld", "coco_degraded", "coco_paired", "cocov2"]


def _build_both(kind, trees):
    from edtr_tpu import config as JC
    from edtr_torch import config as TC

    target, params = _dataset_params(kind, trees)
    node = {"target": target, "params": dict(params, file_backend_cfg=BACKEND)}
    return TC.instantiate_from_config(node), JC.instantiate_from_config(node)


@pytest.mark.parametrize("kind", DATASETS)
def test_dataset_items_match_jax(kind, trees):
    ds_t, ds_j = _build_both(kind, trees)
    assert type(ds_t).__module__.startswith("edtr_torch.data.")
    assert type(ds_t).__name__ == type(ds_j).__name__ and len(ds_t) == len(ds_j) > 0
    for i in range(len(ds_t)):
        with _seeded(100 + i, "jax"):
            want = ds_j[i]
        with _seeded(100 + i, "port"):
            got = ds_t[i]
        _assert_same(got, want, f"{kind}[{i}]")


def test_gt_from_dataset_matches_jax(trees):
    ds_t, ds_j = _build_both("det_paired", trees)
    _assert_same(TCO.gt_from_dataset(ds_t), JCO.gt_from_dataset(ds_j))


# -- the repair: one seed, the same files ------------------------------------------

def _generated(cfg: str, gen, out_name: str) -> dict:
    out = gen(cfg, "det", seed=231, out_name=out_name)
    return {os.path.join(sub, f): open(os.path.join(out, sub, f), "rb").read()
            for sub in ("gt", "lq") for f in sorted(os.listdir(os.path.join(out, sub)))}


def test_val_generation_is_seeded_in_the_port_and_not_in_jax(trees, tmp_path):
    """Two runs of ``generate`` with seed 231 on the VOC tree: the port's
    write identical files; JAX's GT files agree (only the seeded ``random``
    decides them) but its LQ files do not."""
    cfg = _config(tmp_path / "gen.yaml", "datasets.detection.DegradedDetectionDataset",
                  trees["voc"], dict(gt_size=96, out_size=96, crop_type="none", hflip=True,
                                     rotation=False, image_set="val", **CODEFORMER))
    port = [_generated(cfg, TV.generate, f"port{i}") for i in range(2)]
    jax_ = [_generated(cfg, JV.generate, f"jax{i}") for i in range(2)]
    assert port[0] == port[1] and len(port[0]) == 10
    gt = [k for k in jax_[0] if k.startswith("gt")]
    assert all(jax_[0][k] == jax_[1][k] for k in gt)
    assert any(jax_[0][k] != jax_[1][k] for k in jax_[0] if k.startswith("lq"))
    assert all(port[0][k] == jax_[0][k] for k in gt)


def test_val_generation_cli(trees, tmp_path):
    import subprocess
    import sys

    cfg = _config(tmp_path / "cli.yaml", "datasets.detection.DegradedDetectionDataset",
                  trees["voc"], dict(gt_size=64, out_size=64, crop_type="none", hflip=False,
                                     rotation=False, image_set="val", **CODEFORMER))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-m", "edtr_torch.data.val_data_generation",
                          "--config", cfg, "--task", "det", "--limit", "2"], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "wrote 2 gt/lq pairs" in res.stdout


# -- harness -------------------------------------------------------------------------

def test_batching_matches_jax():
    g = np.random.default_rng(11)
    imgs = [g.random((h, w, 3)).astype(np.float32) for h, w in ((40, 64), (64, 33), (17, 5))]
    _assert_same(TH.list_to_batch(imgs, 64), JH.list_to_batch(imgs, 64))
    batch = TH.list_to_batch(imgs, 64)
    _assert_same(TH.batch_to_list(batch, imgs), JH.batch_to_list(batch, imgs))
    tb = TH.batch_to_list(torch.from_numpy(batch), imgs)
    _assert_same([t.numpy() for t in tb], imgs)
    annots = [dict(boxes=g.uniform(0, 60, (n, 4)), labels=g.integers(1, 21, n))
              for n in (0, 3, 120)]
    for max_gt in (TH.MAX_GT, 8):
        _assert_same(TH.pad_annots(annots, max_gt), JH.pad_annots(annots, max_gt))
    items = [(imgs[i], imgs[i][::-1], annots[i], f"p{i}") for i in range(3)]
    _assert_same(TH.collate_fn(items), JH.collate_fn(items))
    _assert_same(TH.prepare_batch(TH.collate_fn(items), 64),
                 JH.prepare_batch(JH.collate_fn(items), 64))


class _Indexed:
    """A dataset whose items are their indices, with VOC images for the
    aspect-ratio groups."""

    def __init__(self, images):
        self.images = images

    def __getitem__(self, i):
        return (i,)

    def __len__(self):
        return len(self.images)


def test_loader_orders_match_jax(trees):
    images = TVOC.voc_file_lists(trees["voc"], "2012", "val", "detection")[0] * 3
    ds = _Indexed(images)
    assert TH.compute_aspect_ratios(ds) == JH.compute_aspect_ratios(ds)
    assert TH.process_rank() == (0, 1)
    for kw in (dict(shuffle=True, aspect_ratio_group_factor=3),
               dict(shuffle=True, aspect_ratio_group_factor=-1),
               dict(shuffle=False, aspect_ratio_group_factor=0),
               dict(shuffle=True, aspect_ratio_group_factor=3, process_index=1, process_count=2),
               dict(shuffle=True, aspect_ratio_group_factor=-1, process_index=0,
                    process_count=2, drop_last=False)):
        loaders = []
        for mod in (TH, JH):
            # the port reads its rank from torch.distributed, JAX's from jax
            extra = {} if mod is TH or "process_count" in kw else dict(process_index=0,
                                                                        process_count=1)
            loaders.append(mod.make_dataloader(ds, batch_size=4, seed=231, **kw, **extra))
        got = [list(b[0]) for b in loaders[0]]
        want = [list(b[0]) for b in loaders[1]]
        assert got == want and len(got) > 0, kw
    group_ids = [i % 3 for i in range(len(ds))]
    order = np.random.default_rng(5).permutation(len(ds)).tolist()
    assert list(TH.GroupedBatchSampler(order, group_ids, 4)) == \
        list(JH.GroupedBatchSampler(order, group_ids, 4))
    assert list(TH.ShardedSampler(order, 2, 3)) == list(JH.ShardedSampler(order, 2, 3))
