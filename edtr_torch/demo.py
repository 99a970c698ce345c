"""The real-world demo on the card: restore an arbitrary-size photo, then
detect, and draw the boxes.

    python -m edtr_torch.demo --config configs/det/demo.yaml --input photo.jpg \\
        [--ckpt combined.pt] [--cldm-tiled] [--vae-encoder-tiled] ...

Counterpart of the root ``demo.py`` with its flags and defaults. The work
is :func:`restore_and_detect`, a function on tensors, which takes the
steps ``demo.py`` takes:

* ``pad_if_smaller(pad_size)`` (512 from the CLI), then
  ``pad_to_multiples_of(64)``;
* SwinIR, on Gaussian-blended tiles with ``pre_res_tiled`` when the
  padded image's longer side is at least 512; the VAE encode (the
  posterior's mode), on GroupNorm-synced tiles with ``vae_encoder_tiled``;
* ``q_sample`` to the pipeline's start timestep, then the spaced walk,
  every eps forward on latent tiles (``cldm_tile_size // 8`` at
  ``cldm_tile_stride // 8``) with ``cldm_tiled``;
* the decode, on GroupNorm-synced latent tiles with
  ``vae_decoder_tiled``, then the wavelet fix;
* detection on the restored (padded) image: ``resize`` (the longer side
  scaled to 512, sizes by ``int()``, bilinear as ``jax.image.resize``
  computes it, boxes scaled back), ``tile`` (the detector on each
  ``sliding_windows`` tile, its detections with scores >= 0.6 offset into
  the image, then class-aware NMS at ``detection_tile_nms_threshold`` over
  all tiles, on the device) or ``direct``.

Each step runs under a ``record_function`` range named as
``profile_restore.RESTORE_DETECT_STAGES``. The CLI alone reads the
images, resizes them (bicubic, PIL), writes the restored image cropped to
the input's size and the box overlay (OpenCV's drawing, as ``demo.py``
draws it), and a JSON of the boxes. Without OpenCV it writes the image and
the JSON and no overlay; without PIL it cannot read an image and stops.
Neither changes what is computed. Weights: a combined checkpoint
(``--ckpt``, :func:`edtr_torch.utils.checkpoint.load_combined`), else
seeded random ones (``--seed``).
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser
from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from edtr_torch.models.resnet import resize_bilinear
from edtr_torch.ops import boxes as box_ops
from edtr_torch.utils.image import pad_if_smaller, pad_to_multiples_of
from edtr_torch.utils.tiling import sliding_windows

DETECTION_TYPES = ("resize", "tile", "direct")
# the tile detection's score floor before the NMS across tiles (demo.py)
TILE_SCORE_MIN = 0.6
# the label names demo.py draws (VOC's 20, 1-indexed; other labels by number)
VOC_LABELS = ("aeroplane bicycle bird boat bottle bus car cat chair cow diningtable "
              "dog horse motorbike person pottedplant sheep sofa train tvmonitor").split()
# the demo's defaults (demo.py's flags)
DEFAULTS = dict(pre_res_tiled=False, pre_res_tile_size=512, pre_res_tile_stride=256,
                vae_encoder_tiled=False, vae_encoder_tile_size=256,
                vae_decoder_tiled=False, vae_decoder_tile_size=256,
                cldm_tiled=False, cldm_tile_size=512, cldm_tile_stride=256,
                detection_type="resize", detection_tile_size=512,
                detection_tile_stride=256, detection_tile_nms_threshold=0.3)


def _detect_tiles(detnet, res: torch.Tensor, size: int, stride: int,
                  nms_threshold: float) -> Dict[str, torch.Tensor]:
    """The detector on each tile of ``res`` (1, 3, H, W), the detections
    with score >= :data:`TILE_SCORE_MIN` offset into the image, then
    class-aware NMS over all of them: padded (T * D,) tensors whose
    ``valid`` marks the kept ones, in tile order."""
    boxes, scores, labels, keep = [], [], [], []
    for hi, hi_end, wi, wi_end in sliding_windows(res.shape[2], res.shape[3], size, stride):
        p = detnet(res[:, :, hi:hi_end, wi:wi_end])[0]
        b = p["boxes"][0].clone()
        b[:, 0::2] += wi  # scalars: no host-to-device copy
        b[:, 1::2] += hi
        boxes.append(b)
        scores.append(p["scores"][0])
        labels.append(p["labels"][0])
        keep.append((p["scores"][0] >= TILE_SCORE_MIN) & p["valid"][0])
    boxes, scores, labels, keep = (torch.cat(t) for t in (boxes, scores, labels, keep))
    valid = box_ops.batched_nms_mask(boxes, scores, labels, nms_threshold, keep)
    return dict(boxes=boxes, scores=scores, labels=labels, valid=valid)


@torch.no_grad()
def detect(detnet, res: torch.Tensor, detection_type: str = "resize", tile_size: int = 512,
           tile_stride: int = 256, nms_threshold: float = 0.3) -> Dict[str, torch.Tensor]:
    """The demo's detection on a restored (1, 3, H, W) image: ``resize``
    (the longer side to 512, sizes by ``int()``, boxes scaled back),
    ``tile`` (:func:`_detect_tiles`) or ``direct``; one image's
    detections, or the tiles'."""
    if detection_type == "resize":
        s = 512 / max(res.shape[2:])
        small = resize_bilinear(res, (int(res.shape[2] * s), int(res.shape[3] * s)))
        dets = {k: v[0] for k, v in detnet(small)[0].items()}
        dets["boxes"] = dets["boxes"] / s
        return dets
    if detection_type == "tile":
        return _detect_tiles(detnet, res, tile_size, tile_stride, nms_threshold)
    return {k: v[0] for k, v in detnet(res)[0].items()}


@torch.no_grad()
def restore_and_detect(pipe, detnet, image: torch.Tensor, *, pad_size: int = 512,
                       noise: Optional[torch.Tensor] = None,
                       step_noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       c_txt: Optional[torch.Tensor] = None, **options) -> dict:
    """Restore ``image`` (1, H, W, 3) in [0, 1] and detect on it, as the
    module docstring lists; ``options`` are :data:`DEFAULTS`' keys.
    ``noise``: the q_sample draw (1, 4, h, w) of the padded image's
    latent; ``step_noise``: (K, 1, 4, h, w), one per walk step; missing
    ones are drawn from ``generator``. ``c_txt``: the text embedding, the
    empty prompt's by default. Returns NHWC ``restored`` and
    ``pre_restored`` (the padded size), the latent ``z`` (NCHW) and the
    ``detections`` (``boxes`` in the padded image's pixels, ``scores``,
    ``labels``, ``valid``; one image's, or the tiles' with ``tile``)."""
    unknown = set(options) - set(DEFAULTS)
    if unknown:
        raise TypeError(f"restore_and_detect: unknown options {sorted(unknown)}")
    o = {**DEFAULTS, **options}
    if o["detection_type"] not in DETECTION_TYPES:
        raise ValueError(f"detection_type {o['detection_type']!r}: one of {DETECTION_TYPES}")
    dev = pipe.device
    x = image.to(dev, torch.float32).permute(0, 3, 1, 2)
    x = pad_to_multiples_of(pad_if_smaller(x, pad_size), 64)
    with record_function("swinir"):
        tile = ((o["pre_res_tile_size"], o["pre_res_tile_stride"])
                if o["pre_res_tiled"] and max(x.shape[2:]) >= 512 else None)
        pre = pipe.pre_restore(x, tile)
    with record_function("vae_encode"):
        z_pre = pipe.encode(pre, o["vae_encoder_tiled"], o["vae_encoder_tile_size"])
    with record_function("text"):
        c_txt = pipe.text(1) if c_txt is None else c_txt.to(dev, torch.float32)
    with record_function("scan"):
        if noise is None:
            noise = torch.randn(z_pre.shape, generator=generator, device=dev)
        tile = ((o["cldm_tile_size"] // 8, o["cldm_tile_stride"] // 8)
                if o["cldm_tiled"] else None)
        z = pipe.denoise(z_pre, c_txt, noise.to(dev), step_noise, generator, tile)
    with record_function("decode+wavelet"):
        res = pipe.decode(z, pre, o["vae_decoder_tiled"], o["vae_decoder_tile_size"])
    with record_function("detect"):
        dets = detect(detnet, res, o["detection_type"], o["detection_tile_size"],
                      o["detection_tile_stride"], o["detection_tile_nms_threshold"])
    return dict(restored=res.permute(0, 2, 3, 1), pre_restored=pre.permute(0, 2, 3, 1),
                z=z, detections=dets)


def draw_boxes(img01: np.ndarray, pred: Dict[str, np.ndarray], threshold: float,
               labels_text=VOC_LABELS) -> np.ndarray:
    """The box overlay of ``demo.py:draw_boxes`` (OpenCV): each valid box
    at or above ``threshold`` in a colour drawn from
    ``np.random.default_rng(label)``, with its label's name and score."""
    import cv2

    img = (img01 * 255).astype(np.uint8).copy()
    for box, score, label, v in zip(pred["boxes"], pred["scores"], pred["labels"],
                                    pred["valid"]):
        if not v or score < threshold:
            continue
        x1, y1, x2, y2 = (int(round(float(c))) for c in box)
        color = tuple(int(c) for c in np.random.default_rng(int(label)).integers(64, 255, 3))
        cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
        name = (labels_text[int(label) - 1] if labels_text and 0 < int(label) <= len(labels_text)
                else str(int(label)))
        cv2.putText(img, f"{name}:{float(score):.2f}", (x1, max(y1 - 4, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    return img


def build(config: str, ckpt: Optional[str], seed: int, device=None):
    """(pipeline, detector) of a demo config, bf16, on the card unless a
    device is named; the combined checkpoint's weights, else the
    constructors' seeded random ones."""
    from edtr_torch.config import instantiate_from_config, load_config
    from edtr_torch.pipeline import build_pipeline_from_config
    from edtr_torch.utils.checkpoint import load_combined

    torch.manual_seed(seed)
    cfg = load_config(config)
    pipe = build_pipeline_from_config(cfg, dtype=torch.bfloat16, device=device).eval()
    detnet = instantiate_from_config(cfg.model.detnet, dtype=torch.bfloat16,
                                     device=pipe.device).eval()
    if ckpt:
        load_combined(ckpt, pipe, detnet)
    return pipe, detnet


def main(args) -> None:
    from PIL import Image  # reading and resizing the photos needs PIL

    try:
        import cv2  # noqa: F401
        have_cv2 = True
    except ImportError:
        have_cv2 = False
        print("OpenCV is not installed: writing the restored images and the boxes' JSON, "
              "no overlay")
    pipe, detnet = build(args.config, args.ckpt, args.seed)
    options = {k: getattr(args, k) for k in DEFAULTS}
    img_dir, box_dir = os.path.join(args.output, "images"), os.path.join(args.output, "boxes")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(box_dir, exist_ok=True)
    exts = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
    paths = ([args.input] if os.path.isfile(args.input) else
             sorted(os.path.join(args.input, f) for f in os.listdir(args.input)
                    if f.lower().endswith(exts)))
    generator = torch.Generator(device=pipe.device).manual_seed(args.seed)
    c_txt = pipe.text(1)
    for path in paths:
        img = Image.open(path).convert("RGB")
        scale = 512 / max(img.size) if args.scale == -1.0 else args.scale
        img = img.resize((int(round(img.size[0] * scale)), int(round(img.size[1] * scale))),
                         Image.BICUBIC)
        x = torch.from_numpy(np.asarray(img, np.float32) / 255.0)[None]
        h0, w0 = x.shape[1:3]
        out = restore_and_detect(pipe, detnet, x, generator=generator, c_txt=c_txt, **options)
        pred = {k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
                for k, v in out["detections"].items()}
        res = np.clip(out["restored"][0, :h0, :w0].float().cpu().numpy(), 0, 1)
        base = os.path.splitext(os.path.basename(path))[0]
        Image.fromarray((res * 255).astype(np.uint8)).save(os.path.join(img_dir, base + ".png"))
        shown = pred["valid"] & (pred["scores"] > args.threshold)
        with open(os.path.join(box_dir, base + ".json"), "w") as f:
            json.dump({k: pred[k][shown].tolist() for k in ("boxes", "scores", "labels")}, f)
        if have_cv2:
            Image.fromarray(draw_boxes(res, pred, args.threshold)).save(
                os.path.join(box_dir, base + ".png"))
        print(f"{path}: {int(shown.sum())} boxes")
    print("Done!")


def parser() -> ArgumentParser:
    p = ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", type=str, default="configs/det/demo.yaml")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--input", type=str, required=True)
    p.add_argument("--output", type=str, default="results")
    p.add_argument("--seed", type=int, default=217)
    p.add_argument("--scale", type=float, default=-1.0)
    p.add_argument("--threshold", type=float, default=0.8)
    for key, value in DEFAULTS.items():
        flag = "--" + key.replace("_", "-")
        if isinstance(value, bool):
            p.add_argument(flag, action="store_true")
        elif key == "detection_type":
            p.add_argument(flag, type=str, default=value, choices=DETECTION_TYPES)
        else:
            p.add_argument(flag, type=type(value), default=value)
    return p


if __name__ == "__main__":
    main(parser().parse_args())
