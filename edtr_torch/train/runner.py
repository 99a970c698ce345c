"""Recipe runner of the port: models and data built from a reference-style
YAML config, and the training and evaluation loops.

Counterpart of ``edtr_tpu/train/runner.py``, under JAX's function names;
``python -m edtr_torch.cli`` calls these as the 30 ``main/{cls,seg,det}``
scripts call JAX's. Each loop is the reference's boilerplate (config ->
environment -> models -> optimizers -> loaders -> step loop with log /
checkpoint / image / validation blocks; ``--debug`` sets every block to
fire at every step of 2, as JAX's), on the port's steps
(``train/edtr_step.py``, ``train/recipes.py``) and hooks
(``train/tasks.py``, ``train/valhooks.py``).

How the port differs, and why:

* The weights live in the modules: ``build_edtr_models`` returns the
  pipeline with them loaded (an SD2.1 checkpoint through
  ``utils/checkpoint.load_pretrained_sd``, else seeded
  ``models.layers.randomize_`` weights), the ControlNet from
  ``resume_cldm`` or ``controlnet_from_unet``, the SwinIR from
  ``resume_swinir`` (else seed 0, as JAX's ``PRNGKey(0)``), and the VAE
  decoder from ``resume_decoder``, which JAX's reads nowhere (ROADMAP
  Queue 3). Checkpoints are torch state dicts under the reference's keys
  (``utils/checkpoint.py``).
* Randomness comes from one ``torch.Generator`` on the device, seeded from
  ``train.seed`` (the loops) or ``seed`` (the evaluations): the same
  distributions as JAX's key splits, not their values. Seeded inits derive
  a second seed by :func:`fold_in` where JAX folds its key.
* Everything runs on the card unless the caller names ``device``. Over
  several processes (``edtr_torch.parallel.distributed``'s launch
  contract) each rank trains on its loader shard and its card (the EDTR
  loops' steps on its rows of the global draws, :func:`_rank_generator`),
  every loop's steps average their gradients over the ranks (JAX's
  ``task_train``, ``edtr_train_task`` and ``diffbir_train`` take no mesh,
  so their processes would each update their own weights: ROADMAP Queue
  3), rank 0 alone writes the checkpoints (after a barrier), the image
  grids and the logs, and the logged metrics are the ranks' mean.
* JAX's runner raises ``KeyError`` on two detection paths (the oracle and
  LQ test configs, which have no ``cldm``, passed to ``edtr_eval``; ``task
  ="det"`` in the restore-then-task evaluations); the port raises
  ``NotPortedError`` naming the ROADMAP Queue 3 entry.
* A loader that yields no batch (a dataset smaller than the batch under
  grouped or ``drop_last`` batching) raises ``ValueError``; JAX's loop
  would spin on it forever.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from edtr_torch.config import Config, NotPortedError, instantiate_from_config, load_config
from edtr_torch.device import resolve_device
from edtr_torch.models.layers import randomize_
from edtr_torch.parallel.distributed import barrier, mean_over_ranks, process_rank
from edtr_torch.pipeline import build_pipeline_from_config, swinir_from_config
from edtr_torch.train import recipes as R
from edtr_torch.train import valhooks as V
from edtr_torch.train.edtr_step import (EDTRTrainState, cast_frozen_bf16,
                                        make_edtr_generic_train_step, make_edtr_sample_fn,
                                        make_edtr_train_step)
from edtr_torch.train.harness import list_to_batch, make_dataloader, pad_annots, prepare_batch
from edtr_torch.train.tasks import task_apply_for
from edtr_torch.utils import checkpoint as ckpt
from edtr_torch.utils.image import calculate_psnr
from edtr_torch.utils.logging_utils import prepare_environment

NET_KEYS = {"cls": "clsnet", "seg": "segnet", "det": "detnet"}
# the square the detection loops pad their images to (the reference's 512)
IMG_SIZE = 512
# the models' compute dtype (JAX's runner builds them in bf16; fp32
# parameters)
DTYPE = torch.bfloat16
# ROADMAP Queue 3's entries for JAX's faults the port does not copy
FAULT_DET_EVAL = ("JAX's test_det passes the oracle and LQ detection configs, which have no "
                  "'cldm', to edtr_eval (KeyError 'cldm'); ROADMAP Queue 3")
FAULT_DET_RESTORE_EVAL = ("JAX's _restore_eval_loop has no detection branch (KeyError 'det' "
                          "from main/det/test_swinir.py and test_diffbir.py); ROADMAP Queue 3")


def fold_in(seed: int, data: int) -> int:
    """A seed derived from ``seed`` and ``data``, where JAX derives a key by
    ``jax.random.fold_in`` (not JAX's values)."""
    return int(np.random.SeedSequence([seed, data]).generate_state(1)[0])


def seeded_(module: nn.Module, seed: int) -> nn.Module:
    """``module``'s parameters drawn by ``randomize_`` from ``seed`` on its
    device (JAX's ``init`` from a key)."""
    dev = next(module.parameters()).device
    return randomize_(module, torch.Generator(device=dev).manual_seed(seed))


def _node(cfg: Config) -> Config:
    return cfg.get("train", None) or cfg.get("test", None) or Config()


def _lr(node: Config, key: str, default: float) -> float:
    """A learning rate of the config as a float: the repo's configs write
    them as ``1e-4``, which YAML reads as a string (JAX's runner passes the
    string on, ROADMAP Queue 3)."""
    return float(node.get(key, default))


def _exists(path) -> bool:
    return bool(path) and os.path.exists(str(path))


def build_edtr_models(cfg: Config, dtype: Optional[torch.dtype] = None,
                      device=None) -> nn.Module:
    """The config's pipeline (``build_pipeline_from_config``) with its
    weights, per ``train`` (else ``test``): ``sd_path`` (an SD2.1
    checkpoint: UNet, VAE, CLIP) or seeded weights (``seed``, 231); the
    ControlNet from ``resume_cldm`` or from the UNet; the SwinIR from
    ``resume_swinir`` or seed 0; the VAE decoder from ``resume_decoder``.
    JAX's ``build_edtr_models`` (``runner.py:30-78``) reads all but the
    last."""
    pipe = build_pipeline_from_config(cfg, dtype=dtype or DTYPE, device=device)
    node = _node(cfg)
    cldm = pipe.cldm
    if _exists(node.get("sd_path", None)):
        ckpt.load_pretrained_sd(cldm, ckpt.load_torch_state_dict(str(node["sd_path"])))
    else:
        seeded_(cldm, node.get("seed", 231))
    if _exists(node.get("resume_cldm", None)):
        ckpt.load_network(str(node["resume_cldm"]), cldm.controlnet)
    else:
        ckpt.controlnet_from_unet(cldm.unet, cldm.controlnet)
    if pipe.swinir is not None:
        if _exists(node.get("resume_swinir", None)):
            ckpt.load_network(str(node["resume_swinir"]), pipe.swinir)
        else:
            seeded_(pipe.swinir, 0)
    if _exists(node.get("resume_decoder", None)):
        ckpt.load_network(str(node["resume_decoder"]), cldm.vae.decoder)
    return pipe


def build_detnet(cfg: Config, key: str, dtype: Optional[torch.dtype] = None,
                 device=None) -> nn.Module:
    """The net of ``model.{key}`` (a detector, or any task net). A MobileNet
    detector whose node names ImageNet weights gets ``norm_frozen``, as
    JAX's factory freezes the norms of named weights; the port loads
    nothing by name."""
    node = cfg["model"][key].to_dict()
    params = dict(node.get("params", None) or {})
    if node["target"].endswith("fasterrcnn_mobilenet_v3_large_fpn"):
        named = [params.pop(k) for k in ("weights", "weights_backbone") if k in params]
        if any(v is not None for v in named):
            params["norm_frozen"] = True
    return instantiate_from_config(dict(node, params=params), dtype=dtype, device=device)


def init_detnet_params(det: nn.Module, seed: int) -> nn.Module:
    """JAX's ``init_detnet_params``: seeded weights (``randomize_``; running
    statistics 0 and 1)."""
    return seeded_(det, seed)


def _build_batch_transform(cfg: Config, logger=None, device=None):
    """The Real-ESRGAN transform of ``dataset.batch_transform`` on
    ``device`` (the COCO v2 recipes), else None."""
    node = cfg["dataset"].get("batch_transform", None)
    if not node:
        return None
    if logger:
        logger("building RealESRGAN batch transform (on-device degradation)")
    return instantiate_from_config(node, device=device)


def _loader(cfg: Config, train_cfg: Config, group: bool = False):
    dataset = instantiate_from_config(cfg["dataset"]["train"])
    return make_dataloader(
        dataset, batch_size=train_cfg.get("batch_size", 16),
        num_workers=train_cfg.get("num_workers", 0),
        aspect_ratio_group_factor=train_cfg.get("aspect_ratio_group_factor", -1) if group
        else -1,
        seed=train_cfg.get("seed", 231))


def _train_environment(cfg_path: str, seed: Optional[int], device):
    """(device, config, ``prepare_environment``'s 5-tuple) of a training
    loop: the device resolved once ``prepare_environment`` has joined the
    process group the environment names, so that an unnamed device is this
    rank's card."""
    cfg = load_config(cfg_path)
    env = prepare_environment(cfg, cfg_path, seed, device)
    return resolve_device(device), cfg, env


def _rank_generator(device, seed: int) -> torch.Generator:
    """A recipe loop's generator: ``seed`` on rank 0 (and in one process), a
    seed folded from it and the rank on the others, so that the ranks draw
    independent noise for their rows (a run over several processes equals
    a one-process run in distribution). The EDTR loops' steps draw from
    ``seed`` on every rank instead, each rank its rows of the global draws
    (``edtr_step``), and their image grids from :func:`_grid_generator`."""
    rank = process_rank()[0]
    return torch.Generator(device=device).manual_seed(fold_in(seed, rank) if rank else seed)


def _grid_generator(device, seed: int) -> torch.Generator:
    """The generator of an EDTR loop's image grids, which rank 0 alone
    draws: apart from the step's, which every rank keeps in step."""
    return torch.Generator(device=device).manual_seed(fold_in(seed, 2))


def _writes_after_barrier() -> bool:
    """Whether this process writes the checkpoints: rank 0, once every rank
    has reached the save."""
    barrier()
    return process_rank()[0] == 0


def _epochs(loader, max_steps: int, start: int = 0):
    """``(step, batch)`` from ``start + 1`` to ``max_steps``, epoch after
    epoch; an epoch with no batch raises ``ValueError``."""
    step = start
    while step < max_steps:
        seen = 0
        for batch in loader:
            seen += 1
            step += 1
            yield step, batch
            if step >= max_steps:
                return
        if not seen:
            raise ValueError(f"the loader yields no batch: {len(loader.dataset)} items at a "
                             f"batch of {loader.batch_sampler.batch_size}")


class _Schedule:
    """Which blocks fire at a step: ``--debug`` fires every one (JAX's
    short-circuit of the ``% every`` conditions) over 2 steps."""

    def __init__(self, cfg: Config, train_cfg: Config, debug: bool, steps: int,
                 ckpt_default: int):
        val_cfg = cfg.get("val", None) or Config()
        self.max_steps = 2 if debug else steps
        self.log_every = 1 if debug else train_cfg.get("log_every", 50)
        self.ckpt_every = 1 if debug else train_cfg.get("ckpt_every", ckpt_default)
        self.val_every = 1 if debug else val_cfg.get("val_every", 0)
        self.image_every = 1 if debug else train_cfg.get("image_every", 0)
        self.val_max = 2 if debug else None

    def fires(self, every: int, step: int) -> bool:
        return bool(every) and step % every == 0


def _log_metrics(logger, writer, step: int, metrics: Dict[str, Any], suffix: str = "") -> None:
    values = mean_over_ranks(metrics)
    logger(f"step {step}: " + " ".join(f"{k}={v:.4f}" for k, v in values.items()) + suffix)
    if writer:
        for k, v in values.items():
            writer.add_scalar(f"train/{k}", v, step)


def _val_dataset(cfg: Config):
    node = cfg["dataset"].get("val", None)
    return instantiate_from_config(node) if node else None


def _on(x, device) -> torch.Tensor:
    return (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))).to(device)


def _targets(annot_list, device) -> Dict[str, torch.Tensor]:
    padded = pad_annots(annot_list)
    return dict(boxes=_on(padded["boxes"], device), labels=_on(padded["labels"], device).long(),
                valid=_on(padded["valid"], device))


def _det_batch(batch, batch_transform, device):
    """(gt, lq, targets, bs) of a detection loader batch on ``device``."""
    _, _, gt_b, lq_b, annot_list, _, bs = prepare_batch(batch, IMG_SIZE, batch_transform)
    return _on(gt_b, device), _on(lq_b, device), _targets(annot_list, device), bs


def _task_batch(batch, device):
    """(gt, lq, target, bs) of a classification or segmentation batch."""
    gt_l, lq_l, target_l, _ = batch
    return (_on(np.stack(gt_l), device), _on(np.stack(lq_l), device),
            _on(np.stack(target_l), device), len(gt_l))


def _text(pipe: nn.Module, node: Config) -> torch.Tensor:
    """(1, 77, width) embedding of ``default_prompt``."""
    with torch.no_grad():
        return pipe.cldm.encode_text([node.get("default_prompt", "")])


def _pre_restore(pipe: nn.Module, lq: torch.Tensor) -> torch.Tensor:
    return pipe.pre_restore(lq.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@torch.no_grad()
def det_eval_fn(det: nn.Module, images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A detector's inference detections of NHWC images."""
    return det(images.permute(0, 3, 1, 2))[0]


@torch.no_grad()
def task_eval_fn(net: nn.Module, images: torch.Tensor):
    """A classification or segmentation net's inference outputs of NHWC
    images in [0, 1], ImageNet-normalised."""
    return net(images.permute(0, 3, 1, 2), normalize=True)


def swinir_restore_fn(swinir: nn.Module) -> Callable:
    """``(lq NHWC, generator) -> restored NHWC``: a standalone SwinIR under
    no grad in the pipeline's default configuration, cropped to the input's
    size (the unshuffling SwinIR returns its padded size, as JAX's does, on
    which JAX's PSNR of an image of another size raises)."""
    @torch.no_grad()
    def restore(lq: torch.Tensor, generator=None) -> torch.Tensor:
        with R.swinir_configuration():
            out = swinir(lq.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return out[:, :lq.shape[1], :lq.shape[2]]
    return restore


def edtr_train(cfg_path: str, debug: bool = False, seed: Optional[int] = None,
               device=None) -> EDTRTrainState:
    """JAX's ``edtr_train`` (``runner.py:109-300``), the flagship EDTR
    detection loop: two alternating updates a step (AdamW on the ControlNet
    and decoder, SGD on the detector), ``frozen_bf16`` (default on),
    ``accum_steps`` microbatches, ``resume_state`` from
    ``checkpoints/trainstate_last.pt``; every ``log_every`` a line and the
    scalars, every ``ckpt_every`` the submodules and the whole train state,
    every ``image_every`` a grid of gt / lq / pre_restored / restored, every
    ``val.val_every`` a restore-then-detect COCO validation."""
    device, cfg, (exp_dir, ckpt_dir, img_dir, logger, writer) = _train_environment(
        cfg_path, seed, device)
    train_cfg = cfg["train"]
    train_seed = train_cfg.get("seed", 231)

    pipe = build_edtr_models(cfg, device=device)
    detnet = init_detnet_params(build_detnet(cfg, "detnet", DTYPE, device), train_seed)
    teacher = init_detnet_params(build_detnet(cfg, "detnet", DTYPE, device),
                                 fold_in(train_seed, 1))
    for name, module, field in (("detnet", detnet, "resume_detnet"),
                                ("teacher_detnet", teacher, "resume_teacher_detnet")):
        if _exists(train_cfg.get(field, None)):
            logger(f"loading {name} from {train_cfg[field]}")
            ckpt.load_network(str(train_cfg[field]), module, strict=False)
    if train_cfg.get("frozen_bf16", True):
        cast_frozen_bf16(pipe, pipe.cldm.vae.train_decoder, teacher)
    state = EDTRTrainState.create(
        pipe, learning_rate_edtr=_lr(train_cfg, "learning_rate_edtr", 1e-4),
        train_steps=train_cfg.get("train_steps", 10000), detnet=detnet, teacher_detnet=teacher,
        learning_rate_detnet=_lr(train_cfg, "learning_rate_detnet", 5e-3))
    accum_steps = int(train_cfg.get("accum_steps", 1))
    if accum_steps > 1:
        logger(f"gradient accumulation: {accum_steps} microbatches/step")
    step_fn = make_edtr_train_step(
        pipe, detnet=detnet, teacher_detnet=teacher,
        weight_hlf=train_cfg.get("weight_hlf", 0.5), weight_det=train_cfg.get("weight_det", 1.0),
        weight_fm=train_cfg.get("weight_fm", 0.2), accum_steps=accum_steps)
    sample_fn = make_edtr_sample_fn(pipe)

    loader = _loader(cfg, train_cfg, group=True)
    batch_transform = _build_batch_transform(cfg, logger, device)
    c_txt_one = _text(pipe, train_cfg)
    sched = _Schedule(cfg, train_cfg, debug, train_cfg.get("train_steps", 10000), 10000)
    val_ds = _val_dataset(cfg)

    state_path = os.path.join(ckpt_dir, "trainstate_last.pt")
    if train_cfg.get("resume_state", False) and os.path.exists(state_path):
        ckpt.restore_checkpoint(state_path, state)
        logger(f"resumed full train state at step {state.step}")

    gen, grid_gen = (torch.Generator(device=device).manual_seed(train_seed),
                     _grid_generator(device, train_seed))
    start, t0 = state.step, time.time()
    for global_step, batch in _epochs(loader, sched.max_steps, state.step):
        gt, lq, targets, bs = _det_batch(batch, batch_transform, device)
        dev_batch = dict(lq=lq, gt=gt, c_txt=c_txt_one.expand(bs, -1, -1), targets=targets)
        metrics = step_fn(state, dev_batch, generator=gen)
        if sched.fires(sched.log_every, global_step):
            _log_metrics(logger, writer, global_step, metrics,
                         f" ({(time.time() - t0) / (global_step - start):.2f}s/step)")
        if sched.fires(sched.ckpt_every, global_step) and _writes_after_barrier():
            save = dict(controlnet=pipe.cldm.controlnet, decoder=pipe.cldm.vae.decoder,
                        detnet=detnet)
            if pipe.swinir is not None:
                save["swinir"] = pipe.swinir
            ckpt.save_submodules(ckpt_dir, save, step=global_step)
            ckpt.save_checkpoint(state_path, state)
            logger(f"checkpoints saved at step {global_step}")
        if sched.fires(sched.image_every, global_step) and process_rank()[0] == 0:
            k = min(4, bs)
            restored = sample_fn(lq[:k], dev_batch["c_txt"][:k], generator=grid_gen)
            path = V.save_image_grid(img_dir, global_step, dict(
                gt=gt[:k], lq=lq[:k], pre_restored=_pre_restore(pipe, lq[:k]),
                restored=restored))
            logger(f"image grid saved: {path}")
        if val_ds is not None and sched.fires(sched.val_every, global_step):
            stats = V.validate_detection(
                val_ds, det_eval_fn, detnet, gen,
                restore_fn=lambda x, g: sample_fn(x, c_txt_one, generator=g),
                max_images=sched.val_max, img_size=IMG_SIZE, device=device)
            V.log_val_stats(logger, writer, global_step, stats)
    logger("training done")
    if writer:
        writer.close()
    return state


def task_train(cfg_path: str, task: str, recipe: str = "task", debug: bool = False,
               seed: Optional[int] = None, device=None):
    """JAX's ``task_train`` (``runner.py:368-573``): ``recipe`` "task" (the
    task net on gt with ``dataset.use_gt``, else lq), "swinir" (on a frozen
    SwinIR's restoration), "swinir-pre" (SwinIR alone, L1 x 255, AdamW
    without decay) or "sr4ir" (SwinIR and the task net, ``pix_weight``);
    the task net by SGD, weight decay 1e-6 for seg and 1e-4 otherwise, a
    detector's frozen stages masked. Returns the state (a pair for
    SR4IR)."""
    device, cfg, (exp_dir, ckpt_dir, img_dir, logger, writer) = _train_environment(
        cfg_path, seed, device)
    train_cfg = cfg["train"]
    train_seed = train_cfg.get("seed", 231)
    net_key = NET_KEYS[task]
    # SwinIR pre-training trains no task net (JAX's builds one and raises
    # KeyError on the configs, which name none; ROADMAP Queue 3)
    net = (None if recipe == "swinir-pre"
           else seeded_(build_detnet(cfg, net_key, DTYPE, device), train_seed))

    swinir = None
    if recipe in ("swinir", "swinir-pre", "sr4ir") and "swinir" in cfg["model"]:
        swinir = swinir_from_config(cfg["model"]["swinir"], dtype=DTYPE, device=device)
        if _exists(train_cfg.get("resume_swinir", None)):
            ckpt.load_network(str(train_cfg["resume_swinir"]), swinir)
        else:
            seeded_(swinir, fold_in(train_seed, 7))

    loss_fn, feats_fn = task_apply_for(task)
    lr = _lr(train_cfg, "learning_rate", 1e-3)
    steps = train_cfg.get("train_steps", 10000)
    sgd_wd = 1e-6 if task == "seg" else 1e-4  # main/seg/train_seg.py:46 vs 1e-4
    if recipe == "swinir-pre":
        state = R.SimpleTrainState.create(swinir, R.cosine_tx("adamw", lr, steps,
                                                              weight_decay=0.0))
        step = R.make_swinir_pre_train_step(swinir)

        def step_fn(state, batch, generator):
            return step(state, batch)
    elif recipe == "sr4ir":
        sw_state = R.SimpleTrainState.create(swinir, R.cosine_tx(
            "adamw", _lr(train_cfg, "learning_rate_swinir", lr), steps, weight_decay=0.0))
        t_state = R.SimpleTrainState.create(net, R.cosine_tx(
            "sgd", _lr(train_cfg, "learning_rate_task", lr), steps, weight_decay=sgd_wd))
        state = (sw_state, t_state)
        step = R.make_sr4ir_train_step(swinir, feats_fn, loss_fn,
                                       pix_weight=train_cfg.get("pix_weight", 255.0))

        def step_fn(state, batch, generator):
            return step(state, batch, generator=generator)
    else:
        state = R.SimpleTrainState.create(net, R.cosine_tx("sgd", lr, steps,
                                                           weight_decay=sgd_wd))
        step_fn = R.make_task_train_step(loss_fn, pre_restore=swinir if recipe == "swinir"
                                         else None,
                                         use_gt=bool(cfg["dataset"].get("use_gt", False)))

    loader = _loader(cfg, train_cfg)
    batch_transform = _build_batch_transform(cfg, logger, device)
    sched = _Schedule(cfg, train_cfg, debug, steps, steps)
    val_ds = _val_dataset(cfg)
    sw_restore = swinir_restore_fn(swinir) if swinir is not None else None
    restore = sw_restore if recipe in ("swinir-pre", "sr4ir", "swinir") else None
    eval_net = {"sr4ir": lambda: state[1].module, "swinir-pre": lambda: None}.get(
        recipe, lambda: state.module)

    gen = _rank_generator(device, train_seed)
    for global_step, batch in _epochs(loader, sched.max_steps):
        if task == "det":
            gt, lq, target, bs = _det_batch(batch, batch_transform, device)
        else:
            gt, lq, target, bs = _task_batch(batch, device)
        metrics = step_fn(state, dict(gt=gt, lq=lq, target=target), generator=gen)
        if sched.fires(sched.log_every, global_step):
            _log_metrics(logger, writer, global_step, metrics)
        if sched.fires(sched.ckpt_every, global_step) and _writes_after_barrier():
            if recipe == "sr4ir":
                save = {"swinir": swinir, net_key: net}
            elif recipe == "swinir-pre":
                save = {"swinir": swinir}
            else:
                save = {net_key: net}
            ckpt.save_submodules(ckpt_dir, save, global_step)
        if sched.fires(sched.image_every, global_step) and process_rank()[0] == 0:
            k = min(4, gt.shape[0])
            rows = dict(gt=gt[:k], lq=lq[:k])
            if restore is not None:
                rows["restored"] = restore(lq[:k], gen)
            path = V.save_image_grid(img_dir, global_step, rows)
            logger(f"image grid saved: {path}")
        if val_ds is not None and sched.fires(sched.val_every, global_step):
            net_now = eval_net()
            if task == "det" and net_now is not None:
                stats = V.validate_detection(val_ds, det_eval_fn, net_now, gen,
                                             restore_fn=restore, max_images=sched.val_max,
                                             img_size=IMG_SIZE, device=device)
            elif net_now is not None:
                stats = V.validate_task(task, val_ds, task_eval_fn, net_now, gen,
                                        restore_fn=restore, max_images=sched.val_max,
                                        device=device)
            else:  # swinir-pre: the restoration's PSNR alone
                n_v = min(len(val_ds), sched.val_max or len(val_ds))
                psnrs = []
                for i in range(n_v):
                    g_i, l_i = val_ds[i][0], val_ds[i][1]
                    r = restore(_on(np.asarray(l_i, np.float32), device)[None], gen)
                    g_t = _on(np.asarray(g_i, np.float32), device)[None]
                    psnrs.append(float(calculate_psnr(r.permute(0, 3, 1, 2),
                                                      g_t.permute(0, 3, 1, 2))[0]))
                stats = dict(psnr=float(np.mean(psnrs)))
            V.log_val_stats(logger, writer, global_step, stats)
    logger("training done")
    if writer:
        writer.close()
    return state


def _task_nets(cfg: Config, task: str, train_seed: int, device):
    """(net key, student, teacher): the config's task net seeded, its
    teacher a copy (JAX's teacher starts from the student's variables)."""
    net_key = NET_KEYS[task]
    student = seeded_(build_detnet(cfg, net_key, DTYPE, device), train_seed)
    return net_key, student, copy.deepcopy(student)


def edtr_train_task(cfg_path: str, task: str, debug: bool = False,
                    seed: Optional[int] = None, device=None) -> EDTRTrainState:
    """JAX's ``edtr_train_task`` (``runner.py:576-708``): the two-half EDTR
    step with a classification or segmentation net
    (``make_edtr_generic_train_step``), the nets from
    ``resume_{clsnet,segnet}`` / ``resume_teacher_*``, the task net's SGD at
    ``learning_rate_task`` (else ``learning_rate_detnet``), ``weight_ce``
    (else ``weight_det``) on its loss; blocks as :func:`edtr_train`'s, the
    checkpoints the ControlNet, the decoder and the task net."""
    if task not in ("cls", "seg"):
        raise ValueError(f"task {task!r}: cls or seg")
    device, cfg, (exp_dir, ckpt_dir, img_dir, logger, writer) = _train_environment(
        cfg_path, seed, device)
    train_cfg = cfg["train"]
    pipe = build_edtr_models(cfg, device=device)
    net_key, student, teacher = _task_nets(cfg, task, train_cfg.get("seed", 231), device)
    for module, field in ((student, f"resume_{net_key}"),
                          (teacher, f"resume_teacher_{net_key}")):
        if _exists(train_cfg.get(field, None)):
            ckpt.load_network(str(train_cfg[field]), module, strict=False)
    loss_fn, feats_fn = task_apply_for(task)
    state = EDTRTrainState.create(
        pipe, learning_rate_edtr=_lr(train_cfg, "learning_rate_edtr", 1e-4),
        train_steps=train_cfg.get("train_steps", 10000), detnet=student, teacher_detnet=teacher,
        learning_rate_detnet=_lr(train_cfg, "learning_rate_task",
                                 _lr(train_cfg, "learning_rate_detnet", 5e-3)))
    accum_steps = int(train_cfg.get("accum_steps", 1))
    if accum_steps > 1:
        logger(f"gradient accumulation: {accum_steps} microbatches/step")
    step_fn = make_edtr_generic_train_step(
        pipe, student, teacher, feats_fn, loss_fn, weight_hlf=train_cfg.get("weight_hlf", 0.5),
        weight_task=train_cfg.get("weight_ce", train_cfg.get("weight_det", 1.0)),
        weight_fm=train_cfg.get("weight_fm", 0.2), accum_steps=accum_steps)
    sample_fn = make_edtr_sample_fn(pipe)

    loader = _loader(cfg, train_cfg)
    c_txt_one = _text(pipe, train_cfg)
    sched = _Schedule(cfg, train_cfg, debug, train_cfg.get("train_steps", 10000), 10000)
    val_ds = _val_dataset(cfg)
    train_seed = train_cfg.get("seed", 231)
    gen, grid_gen = (torch.Generator(device=device).manual_seed(train_seed),
                     _grid_generator(device, train_seed))
    for global_step, batch in _epochs(loader, sched.max_steps):
        gt, lq, target, bs = _task_batch(batch, device)
        dev_batch = dict(gt=gt, lq=lq, target=target, c_txt=c_txt_one.expand(bs, -1, -1))
        metrics = step_fn(state, dev_batch, generator=gen)
        if sched.fires(sched.log_every, global_step):
            _log_metrics(logger, writer, global_step, metrics)
        if sched.fires(sched.ckpt_every, global_step) and _writes_after_barrier():
            ckpt.save_submodules(ckpt_dir, {"controlnet": pipe.cldm.controlnet,
                                            "decoder": pipe.cldm.vae.decoder,
                                            net_key: student}, global_step)
        if sched.fires(sched.image_every, global_step) and process_rank()[0] == 0:
            k = min(4, bs)
            restored = sample_fn(lq[:k], dev_batch["c_txt"][:k], generator=grid_gen)
            path = V.save_image_grid(img_dir, global_step, dict(
                gt=gt[:k], lq=lq[:k], pre_restored=_pre_restore(pipe, lq[:k]),
                restored=restored))
            logger(f"image grid saved: {path}")
        if val_ds is not None and sched.fires(sched.val_every, global_step):
            stats = V.validate_task(
                task, val_ds, task_eval_fn, student, gen,
                restore_fn=lambda x, g: sample_fn(x, c_txt_one, generator=g),
                max_images=sched.val_max, device=device)
            V.log_val_stats(logger, writer, global_step, stats)
    logger("training done")
    if writer:
        writer.close()
    return state


def _eval_net(cfg: Config, task: str, seed: int, device) -> nn.Module:
    """The config's task net from ``test.resume_{net}`` (else seeded, with
    JAX's warning)."""
    test_cfg = cfg.get("test", None) or cfg.get("val", Config())
    net_key = NET_KEYS[task]
    net = seeded_(build_detnet(cfg, net_key, DTYPE, device), seed)
    resume = test_cfg.get(f"resume_{net_key}", None)
    if _exists(resume):
        ckpt.load_network(str(resume), net, strict=False)
    else:
        print(f"WARNING: resume_{net_key} not found ({resume!r}); "
              "evaluating a randomly-initialized task net")
    return net


def _task_loop(task: str, dataset, net: nn.Module, n: int, device,
               restore_fn: Optional[Callable] = None, generator=None) -> Dict[str, float]:
    """PSNR (of the restored image, else of lq) and top-1 / mIoU over the
    first ``n`` items, image by image."""
    psnrs, correct, total, mats = [], 0, 0, None
    for i in range(n):
        gt, lq, target, _ = dataset[i]
        x = _on(np.asarray(lq, np.float32), device)[None]
        if restore_fn is not None:
            x = restore_fn(x, generator)
        g = _on(np.asarray(gt, np.float32), device)[None]
        psnrs.append(float(calculate_psnr(g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2))[0]))
        hit, mat = V.task_scores(task, task_eval_fn(net, x), target)
        if task == "cls":
            correct, total = correct + hit, total + 1
        else:
            mats = mat if mats is None else mats + mat
    stats = dict(psnr=float(np.mean(psnrs)))
    stats.update(V.task_stats(task, correct, total, mats))
    print(stats)
    return stats


def task_eval(cfg_path: str, task: str, debug: bool = False, seed: int = 231,
              max_images: Optional[int] = None, device=None) -> Dict[str, float]:
    """JAX's ``task_eval`` (``runner.py:711-754``): the task net on the
    degraded images as they are: PSNR of lq against gt, top-1 or mIoU; 4
    images with ``debug``."""
    device = resolve_device(device)
    cfg = load_config(cfg_path)
    dataset = instantiate_from_config(cfg["dataset"]["val"])
    net = _eval_net(cfg, task, seed, device)
    n = min(len(dataset), max_images or (4 if debug else len(dataset)))
    return _task_loop(task, dataset, net, n, device)


def _restore_eval_loop(cfg_path: str, task: str, restore_builder: Callable, debug: bool,
                       seed: int, max_images: Optional[int], device=None) -> Dict[str, float]:
    """JAX's shared restore-then-task evaluation (cls, seg):
    ``restore_builder(cfg, device) -> restore_fn(lq NHWC, generator)``; 2
    images with ``debug``. ``task="det"``, which JAX's scripts pass and its
    loop cannot take, raises ``NotPortedError``."""
    if task == "det":
        raise NotPortedError(FAULT_DET_RESTORE_EVAL)
    device = resolve_device(device)
    cfg = load_config(cfg_path)
    dataset = instantiate_from_config(cfg["dataset"]["val"])
    net = _eval_net(cfg, task, seed, device)
    restore_fn = restore_builder(cfg, device)
    n = min(len(dataset), max_images or (2 if debug else len(dataset)))
    gen = torch.Generator(device=device).manual_seed(seed)
    return _task_loop(task, dataset, net, n, device, restore_fn, gen)


def edtr_eval_task(cfg_path: str, task: str, debug: bool = False, seed: int = 231,
                   max_images: Optional[int] = None, device=None) -> Dict[str, float]:
    """JAX's ``edtr_eval_task``: EDTR's restore, then top-1 / mIoU."""
    def builder(cfg, device):
        pipe = build_edtr_models(cfg, device=device)
        sample_fn = make_edtr_sample_fn(pipe)
        c_txt = _text(pipe, cfg.get("test", None) or Config())
        return lambda lq, g: sample_fn(lq, c_txt, generator=g)

    return _restore_eval_loop(cfg_path, task, builder, debug, seed, max_images, device)


def swinir_eval(cfg_path: str, task: str, debug: bool = False, seed: int = 231,
                max_images: Optional[int] = None, device=None) -> Dict[str, float]:
    """JAX's ``swinir_eval``: the config's SwinIR (``test.resume_swinir``,
    else seed 0), then top-1 / mIoU."""
    def builder(cfg, device):
        test_cfg = cfg.get("test", None) or Config()
        swinir = swinir_from_config(cfg["model"]["swinir"], dtype=DTYPE, device=device)
        if _exists(test_cfg.get("resume_swinir", None)):
            ckpt.load_network(str(test_cfg["resume_swinir"]), swinir)
        else:
            seeded_(swinir, 0)
        return swinir_restore_fn(swinir)

    return _restore_eval_loop(cfg_path, task, builder, debug, seed, max_images, device)


def _diffbir_restore(pipe: nn.Module, steps: int, c_txt_one: torch.Tensor) -> Callable:
    """``(lq NHWC, generator) -> restored NHWC``: DiffBIR's ``steps``-step
    walk from pure noise (``recipes.diffbir_sample``) on the pre-restored
    lq's posterior mode, decoded and wavelet-fixed."""
    def restore(lq: torch.Tensor, generator=None) -> torch.Tensor:
        pre = pipe.pre_restore(lq.permute(0, 3, 1, 2))
        z_pre = pipe.encode(pre)
        x_t = torch.randn(z_pre.shape, generator=generator, device=z_pre.device,
                          dtype=z_pre.dtype)
        c_txt = c_txt_one.expand(lq.shape[0], -1, -1)
        return R.diffbir_sample(pipe, steps, z_pre, pre, c_txt, x_t,
                                generator=generator).permute(0, 2, 3, 1)
    return restore


def diffbir_eval(cfg_path: str, task: str, debug: bool = False, seed: int = 231,
                 max_images: Optional[int] = None, steps: int = 50,
                 device=None) -> Dict[str, float]:
    """JAX's ``diffbir_eval``: the ``steps``-step walk from pure noise, then
    top-1 / mIoU."""
    def builder(cfg, device):
        pipe = build_edtr_models(cfg, device=device)
        return _diffbir_restore(pipe, steps, _text(pipe, cfg.get("test", None) or Config()))

    return _restore_eval_loop(cfg_path, task, builder, debug, seed, max_images, device)


def diffbir_train(cfg_path: str, task: str, debug: bool = False, seed: Optional[int] = None,
                  device=None):
    """JAX's ``diffbir_train`` (``runner.py:879-1026``): the ControlNet by
    the eps objective (AdamW, weight decay 1e-2, ``learning_rate_diffbir``
    else ``learning_rate_edtr``), then the task net (SGD at
    ``learning_rate_task``, every parameter) on ``sample_steps``-step
    restorations (50) with ``weight_ce`` and ``weight_fm`` against a frozen
    teacher; checkpoints the ControlNet and the task net. Returns
    (ControlNet state, task state, teacher)."""
    device, cfg, (exp_dir, ckpt_dir, img_dir, logger, writer) = _train_environment(
        cfg_path, seed, device)
    train_cfg = cfg["train"]
    pipe = build_edtr_models(cfg, device=device)
    net_key, net, teacher = _task_nets(cfg, task, train_cfg.get("seed", 231), device)
    loss_fn, feats_fn = task_apply_for(task)
    steps = train_cfg.get("train_steps", 10000)
    cldm_state = R.diffbir_state(pipe, R.cosine_tx(
        "adamw", _lr(train_cfg, "learning_rate_diffbir",
                     _lr(train_cfg, "learning_rate_edtr", 1e-4)), steps, weight_decay=1e-2))
    task_state = R.SimpleTrainState.create(
        net, R.cosine_tx("sgd", _lr(train_cfg, "learning_rate_task", 5e-3), steps,
                         weight_decay=1e-6 if task == "seg" else 1e-4),
        params=list(net.parameters()))
    step_fn = R.make_diffbir_train_step(pipe, loss_fn, feats_fn,
                                        weight_ce=train_cfg.get("weight_ce", 1.0),
                                        weight_fm=train_cfg.get("weight_fm", 0.2))

    loader = _loader(cfg, train_cfg)
    batch_transform = _build_batch_transform(cfg, logger, device)
    c_txt_one = _text(pipe, train_cfg)
    sched = _Schedule(cfg, train_cfg, debug, steps, steps)
    val_ds = _val_dataset(cfg)
    restore = _diffbir_restore(pipe, train_cfg.get("sample_steps", 50), c_txt_one)
    state = (cldm_state, task_state, teacher)
    gen = _rank_generator(device, train_cfg.get("seed", 231))
    for global_step, batch in _epochs(loader, sched.max_steps):
        if task == "det":
            gt, lq, target, bs = _det_batch(batch, batch_transform, device)
        else:
            gt, lq, target, bs = _task_batch(batch, device)
        metrics = step_fn(state, dict(gt=gt, lq=lq, target=target,
                                      c_txt=c_txt_one.expand(bs, -1, -1)), generator=gen)
        if sched.fires(sched.log_every, global_step):
            _log_metrics(logger, writer, global_step, metrics)
        if sched.fires(sched.ckpt_every, global_step) and _writes_after_barrier():
            ckpt.save_submodules(ckpt_dir, {"controlnet": pipe.cldm.controlnet, net_key: net},
                                 global_step)
        if sched.fires(sched.image_every, global_step) and process_rank()[0] == 0:
            k = min(4, bs)
            path = V.save_image_grid(img_dir, global_step, dict(
                gt=gt[:k], lq=lq[:k], restored=restore(lq[:k], gen)))
            logger(f"image grid saved: {path}")
        if val_ds is not None and sched.fires(sched.val_every, global_step):
            if task == "det":
                stats = V.validate_detection(val_ds, det_eval_fn, net, gen, restore_fn=restore,
                                             max_images=sched.val_max, img_size=IMG_SIZE,
                                             device=device)
            else:
                stats = V.validate_task(task, val_ds, task_eval_fn, net, gen,
                                        restore_fn=restore, max_images=sched.val_max,
                                        device=device)
            V.log_val_stats(logger, writer, global_step, stats)
    logger("training done")
    if writer:
        writer.close()
    return state


def edtr_eval(cfg_path: str, debug: bool = False, seed: int = 231, save_img: bool = False,
              calc_fd: bool = False, max_images: Optional[int] = None,
              device=None) -> Dict[str, float]:
    """JAX's ``edtr_eval`` (``runner.py:1029-1130``): image by image (bs 1,
    padded to 512) EDTR's restore, PSNR on the unpadded crop, detection into
    the 12 COCO stats; ``save_img`` writes each restored image to
    ``test.exp_dir/images/{i:05d}.png``; ``calc_fd`` the teacher's mean
    |FPN '0'| distance between gt and restored. ``test.resume_detnet`` is
    required unless ``debug``; 4 images with ``debug``. A config without a
    ``cldm`` (JAX's test_det passes the oracle and LQ configs) raises
    ``NotPortedError``."""
    from edtr_torch.data.coco import gt_from_dataset
    from edtr_torch.utils.coco_eval import CocoEvaluator

    cfg = load_config(cfg_path)
    if "cldm" not in cfg["model"]:
        raise NotPortedError(FAULT_DET_EVAL)
    device = resolve_device(device)
    test_cfg = cfg.get("test", None) or cfg.get("val", Config())
    pipe = build_edtr_models(cfg, device=device)
    det = init_detnet_params(build_detnet(cfg, "detnet", DTYPE, device), seed)
    path = test_cfg.get("resume_detnet", None)
    if _exists(path):
        ckpt.load_network(str(path), det, strict=False)
    elif not debug:
        raise FileNotFoundError(
            f"resume_detnet missing or not found ({path!r}); refusing to evaluate a "
            "randomly-initialized detector (pass --debug to allow)")

    dataset = instantiate_from_config(cfg["dataset"]["val"])
    evaluator = CocoEvaluator(gt_from_dataset(dataset))
    sample_fn = make_edtr_sample_fn(pipe)
    c_txt = _text(pipe, test_cfg)
    teacher = None
    if calc_fd:
        teacher = init_detnet_params(build_detnet(cfg, "detnet", DTYPE, device),
                                     fold_in(seed, 1))
        if _exists(test_cfg.get("resume_teacher_detnet", None)):
            ckpt.load_network(str(test_cfg["resume_teacher_detnet"]), teacher, strict=False)
    img_dir = None
    if save_img:
        img_dir = os.path.join((cfg.get("test", None) or Config()).get("exp_dir", "results"),
                               "images")
        os.makedirs(img_dir, exist_ok=True)

    psnrs, fds = [], []
    n = min(len(dataset), max_images or (4 if debug else len(dataset)))
    gen = torch.Generator(device=device).manual_seed(seed)
    for i in range(n):
        gt, lq, annot, _ = dataset[i]
        h, w = gt.shape[:2]
        lq_b = _on(list_to_batch([lq], IMG_SIZE), device)
        gt_b = _on(list_to_batch([gt], IMG_SIZE), device)
        restored = sample_fn(lq_b, c_txt, generator=gen)
        psnrs.append(float(calculate_psnr(restored[:, :h, :w].permute(0, 3, 1, 2),
                                          gt_b[:, :h, :w].permute(0, 3, 1, 2))[0]))
        if teacher is not None:
            with torch.no_grad():
                fa = teacher.features(gt_b.permute(0, 3, 1, 2))["0"]
                fb = teacher.features(restored.permute(0, 3, 1, 2))["0"]
            fds.append(float((fa.float() - fb.float()).abs().mean()))
        if img_dir is not None:
            from PIL import Image

            out01 = np.clip(restored[0, :h, :w].float().cpu().numpy(), 0, 1)
            Image.fromarray((out01 * 255).astype(np.uint8)).save(
                os.path.join(img_dir, f"{i:05d}.png"))
        dets = det_eval_fn(det, restored)
        valid = dets["valid"][0]
        evaluator.update({annot["image_id"]: dict(boxes=dets["boxes"][0][valid],
                                                  scores=dets["scores"][0][valid],
                                                  labels=dets["labels"][0][valid])})
    evaluator.synchronize_between_processes()
    evaluator.accumulate()
    stats = evaluator.summarize()
    stats["psnr"] = float(np.mean(psnrs))
    if fds:
        stats["feature_distance"] = float(np.mean(fds))
    print(f"PSNR: {stats['psnr']:.3f}  mAP: {stats['AP']:.4f}  mAP50: {stats['AP50']:.4f}"
          + (f"  FD: {stats['feature_distance']:.4f}" if fds else ""))
    return stats
