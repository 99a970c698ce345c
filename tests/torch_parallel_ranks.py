"""The two ranks of ``tests/test_torch_parallel.py``.

``python tests/torch_parallel_ranks.py PHASE RANK PORT OUT [CONFIG]`` joins
a two-process gloo group through the launch contract's ``EDTR_*``
variables, runs the cases of PHASE ("a": the COCO merge, the loader's rank
shards, tensor parallelism, FSDP; "b": the EDTR detector step, the
SwinIR-pre step, the runner's ``--debug`` runs of the config CONFIG) on
one torch thread, and ``torch.save``s this rank's results to
``OUT/PHASE-RANK.pt``. It imports no JAX. Its functions that make the
tiny nets, the global batches and the draws are shared with the parent
test, which computes the one-process references from them.
"""

from __future__ import annotations

import copy
import os
import sys

import numpy as np
import torch

WORLD = 2
GLOBAL_BATCH = 4
IMAGE = 64  # the tiny flagship's input
DET_ACCUM = (1, 2)  # the microbatches of the detector steps compared
CTX = (77, 64)
DET_KW = dict(num_classes=6, device="cpu", min_size=128, max_size=256,
              rpn_pre_nms_top_n_train=64, rpn_pre_nms_top_n_test=64,
              rpn_post_nms_top_n_train=32, rpn_post_nms_top_n_test=32,
              box_detections_per_img=8, rpn_batch_size_per_image=1024,
              rpn_positive_fraction=1.0, box_batch_size_per_image=64,
              box_positive_fraction=1.0)
# the tiny UNet of JAX's tests/test_tensor_parallel.py, its heads 32 wide:
# 1 head at the first level (which 2 ranks do not divide: gathered) and 2
# at the second (split)
TP_UNET = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
               attention_resolutions=(2, 1), channel_mult=(1, 2), num_head_channels=32,
               transformer_depth=1, context_dim=48, use_linear_in_transformer=True)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


# -- the COCO merge and the loader ---------------------------------------------------------

def coco_gt():
    return {i: dict(boxes=np.asarray([[0.0, 0, 10, 10]]) + i, labels=np.asarray([1]),
                    iscrowd=np.asarray([0]), area=np.asarray([100.0])) for i in range(4)}


def coco_shard(rank: int):
    """Rank ``rank``'s predictions: images 2r and 2r + 1, a ragged number
    of boxes each (one of them off the object)."""
    out = {}
    for i in (2 * rank, 2 * rank + 1):
        n = 1 + 3 * i
        boxes = np.tile(coco_gt()[i]["boxes"], (n, 1))
        boxes[-1] += 6.0 * (i % 2)
        out[i] = dict(boxes=boxes, scores=np.linspace(0.9, 0.4, n), labels=np.ones(n, np.int64))
    return out


class Range:
    """A dataset of ``n`` items whose third field is the index."""

    def __init__(self, n: int):
        self.n = n

    def __getitem__(self, i):
        return (np.zeros((4, 4, 3), np.float32), np.zeros((4, 4, 3), np.float32), i, f"{i}")

    def __len__(self):
        return self.n


LOADERS = [dict(n=32, batch_size=8, seed=7), dict(n=31, batch_size=8, seed=11)]


# -- tensor parallelism and FSDP -------------------------------------------------------------

def tp_unet(**kw):
    from edtr_torch.models.unet import UNetModel

    net = UNetModel(**dict(TP_UNET, **kw))
    g = _gen(1)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g, dtype=p.dtype) * 0.05)
    return net


def unet_inputs(b: int, size: int = 8):
    g = _gen(2)
    return (torch.randn(b, 4, size, size, generator=g, dtype=torch.float64),
            torch.randint(0, 1000, (b,), generator=g).double(),
            torch.randn(b, 4, 48, generator=g, dtype=torch.float64))


def _full(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


# the kernel wrappers a fused-configuration UNet reaches: on the CPU their
# plain versions, on a card their kernels
WRAPPERS = (("edtr_torch.ops.gn_conv", "gn_silu_conv"), ("edtr_torch.ops.gn_conv", "upsample_conv"),
            ("edtr_torch.ops.ln_matmul", "ln_matmuls"), ("edtr_torch.ops.geglu", "ln_geglu_proj"),
            ("edtr_torch.models.attention", "dot_product_attention"))


def _fwd_bwd(net, x, t, c, fused: bool = False):
    """(output, gradients) of ``mean(net(x, t, c)²)``, under the kernels'
    configuration with ``fused``, and how often each wrapper of
    :data:`WRAPPERS` was called."""
    import contextlib
    import importlib

    from edtr_torch.models.layers import fused_conv, fused_proj

    calls = dict.fromkeys([name for _, name in WRAPPERS], 0)
    real = {}
    for mod, name in WRAPPERS:
        m = importlib.import_module(mod)
        real[mod, name] = getattr(m, name)

        def counted(*a, _f=real[mod, name], _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        setattr(m, name, counted)
    try:
        net.zero_grad(set_to_none=True)
        with (fused_conv() if fused else contextlib.nullcontext()), \
                (fused_proj() if fused else contextlib.nullcontext()):
            out = net(x, t, c)
            out.square().mean().backward()
    finally:
        for (mod, name), f in real.items():
            setattr(importlib.import_module(mod), name, f)
    return out.detach(), {n: _full(p.grad) for n, p in net.named_parameters()}, calls


def tp_case(rank: int):
    """The tiny UNet in fp64, at (1, 2): its forward and gradients in one
    process, then under ``shard_params``; stock at 8², and under the
    kernels' configuration at 32² (whose second level's 256 tokens the
    projection kernels take), where every wrapper is reached."""
    from torch.distributed.tensor import DTensor

    from edtr_torch.parallel.mesh import make_mesh
    from edtr_torch.parallel.tp import shard_params

    torch.set_default_dtype(torch.float64)
    try:
        net = tp_unet()
        inputs, fused_inputs = unet_inputs(2), unet_inputs(1, size=32)
        ref, g_ref, _ = _fwd_bwd(net, *inputs)
        fref, fg_ref, _ = _fwd_bwd(net, *fused_inputs, fused=True)
        shard_params(net, make_mesh(1, WORLD))
        out, grads, _ = _fwd_bwd(net, *inputs)
        fout, fgrads, calls = _fwd_bwd(net, *fused_inputs, fused=True)
        return dict(out=out, ref=ref, grads=grads, grads_ref=g_ref,
                    fused=dict(out=fout, ref=fref, grads=fgrads, grads_ref=fg_ref, calls=calls),
                    sharded=sorted(n for n, p in net.named_parameters()
                                   if isinstance(p, DTensor)),
                    local_rows=net.input_blocks[3][1].transformer_blocks[0].attn1.to_q
                    .weight.to_local().shape[0])
    finally:
        torch.set_default_dtype(torch.float32)


def fsdp_case(rank: int):
    """The tiny UNet in fp64 at (2, 1), 1 KiB the least sharded leaf (JAX's
    test): one AdamW step on this rank's half of a batch of 4, against the
    one-process step on all of it."""
    from torch.distributed.tensor import DTensor, Shard

    from edtr_torch.parallel.distributed import average_gradients
    from edtr_torch.parallel.fsdp import shard_params_fsdp
    from edtr_torch.parallel.mesh import make_mesh

    torch.set_default_dtype(torch.float64)
    try:
        net = tp_unet(num_head_channels=16)
        x, t, c = unet_inputs(GLOBAL_BATCH)
        one = copy.deepcopy(net)
        tx_one = torch.optim.AdamW(one.parameters(), lr=1e-3)
        loss_ref = one(x, t, c).square().mean()
        loss_ref.backward()
        g_ref = {n: p.grad.clone() for n, p in one.named_parameters()}
        tx_one.step()

        shard_params_fsdp(net, make_mesh(WORLD, 1), min_bytes=1 << 10)
        tx = torch.optim.AdamW(net.parameters(), lr=1e-3)
        rows = slice(rank * 2, rank * 2 + 2)
        loss = net(x[rows], t[rows], c[rows]).square().mean()
        loss.backward()
        average_gradients(net.parameters())
        grads = {n: _full(p.grad) for n, p in net.named_parameters()}
        tx.step()
        moments = [s["exp_avg"] for s in tx.state.values()]
        return dict(loss=loss.detach(), loss_ref=loss_ref.detach(), grads=grads, grads_ref=g_ref,
                    params={n: _full(p).detach() for n, p in net.named_parameters()},
                    params_ref={n: p.detach() for n, p in one.named_parameters()},
                    sharded_params=sum(isinstance(p, DTensor) and isinstance(p.placements[0], Shard)
                                       for p in net.parameters()),
                    sharded_moments=sum(isinstance(m, DTensor) and isinstance(m.placements[0], Shard)
                                        for m in moments),
                    moments=len(moments))
    finally:
        torch.set_default_dtype(torch.float32)


# -- the training steps ----------------------------------------------------------------------

def det_parts(accum: int = 1):
    """(state, step, global batch, global draws) of the tiny fp32 EDTR
    detector step over ``accum`` microbatches of :data:`GLOBAL_BATCH` (each
    rank's two images: at one image the CPU's kernels round otherwise,
    which the feature L1's sign amplifies to ~2e-4 of the largest
    gradient even in one process): the tiny flagship (decoder
    trained) and the tiny detector (every candidate sampled, so that its
    sampler's uniforms do not matter) with seeded weights, its teacher the
    student times 1.1."""
    from edtr_torch.models import faster_rcnn as TF
    from edtr_torch.models.layers import randomize_
    from edtr_torch.pipeline import build_flagship
    from edtr_torch.train.edtr_step import EDTRTrainState, make_edtr_train_step

    pipe = randomize_(build_flagship(tiny=True, dtype=None, device="cpu"), _gen(0))
    student = randomize_(TF.fasterrcnn_mobilenet_v3_large_fpn(**DET_KW), _gen(1))
    teacher = copy.deepcopy(student)
    with torch.no_grad():
        for p in teacher.parameters():
            p.mul_(1.1)
    state = EDTRTrainState.create(pipe, train_decoder=True, detnet=student,
                                  teacher_detnet=teacher)
    # the EDTR half's update at lr 0, so that the task half restores with
    # the same decoder on both sides: AdamW's first step is ±lr wherever
    # |g| >> eps, so fp32 rounding that flips a near-zero gradient would
    # move a weight by lr (the gradients it is given are compared instead)
    for group in state.tx_edtr.param_groups:
        group["lr"] = 0.0
    step = make_edtr_train_step(pipe, detnet=student, teacher_detnet=teacher,
                                accum_steps=accum)
    b, g = GLOBAL_BATCH * accum, np.random.default_rng(3)
    boxes = np.zeros((b, 3, 4), np.float32)
    xy = g.random((b, 2, 2)) * 36
    boxes[:, :2] = np.concatenate([xy, xy + 12 + g.random((b, 2, 2)) * 16], -1)
    batch = dict(lq=g.random((b, IMAGE, IMAGE, 3)), gt=g.random((b, IMAGE, IMAGE, 3)),
                 c_txt=g.standard_normal((b,) + CTX),
                 targets=dict(boxes=boxes, labels=g.integers(1, 6, (b, 3)),
                              valid=np.array([[True, True, False]] * b)))
    batch = {k: ({kk: torch.as_tensor(vv) for kk, vv in v.items()} if isinstance(v, dict)
                 else torch.as_tensor(v, dtype=torch.float32)) for k, v in batch.items()}
    batch["targets"]["labels"] = batch["targets"]["labels"].long()
    h = IMAGE // 8
    k = len(pipe.used_timesteps)
    bs2 = max(b // 2, 1)
    tg = _gen(4)
    draws = dict(t=torch.as_tensor(pipe.used_timesteps)[torch.randint(0, k, (b,), generator=tg)],
                 noise=torch.randn(b, 4, h, h, generator=tg),
                 q_noise=torch.randn(bs2, 4, h, h, generator=tg),
                 step_noise=torch.randn(k, bs2, 4, h, h, generator=tg))
    return state, step, batch, draws


def global_layout(accum: int) -> list:
    """The rows of the global batch in the order one process steps on them
    to equal ``WORLD`` ranks at ``accum`` microbatches, rank r's loader
    shard rows r·b .. (r+1)·b: global microbatch k is the ranks' k-th
    microbatches, rank 0's first (the identity at one microbatch)."""
    m = GLOBAL_BATCH // WORLD
    b = m * accum
    return [r * b + k * m + j for k in range(accum) for r in range(WORLD) for j in range(m)]


def det_step(rank: int = 0, world: int = 1, accum: int = 1):
    """One step on rank ``rank``'s rows of the global batch (in one
    process, all of them in :func:`global_layout`'s order): its metrics and
    what it updated. At one microbatch the draws are given (rows of the
    global ones); else the step draws them from a generator seeded alike
    on every rank."""
    from edtr_torch.parallel.distributed import mean_over_ranks, rank_rows
    from edtr_torch.train.edtr_step import restored_rows

    state, step, batch, draws = det_parts(accum)
    m = GLOBAL_BATCH * accum // world
    rows = list(range(rank * m, (rank + 1) * m)) if world > 1 else global_layout(accum)
    local = {k: ({kk: vv[rows] for kk, vv in v.items()} if isinstance(v, dict) else v[rows])
             for k, v in batch.items()}
    if accum == 1:
        mine = rank_rows(m)
        q_rows = slice(mine.start, mine.start + restored_rows(m))
        task = [dict(noise=draws["q_noise"][q_rows], step_noise=draws["step_noise"][:, q_rows])]
        metrics = step(state, local, t=draws["t"][mine], noise=draws["noise"][mine],
                       generator=_gen(5), task_draws=task)
    else:
        metrics = step(state, local, generator=_gen(5))
    # the gradients each update used (averaged over the ranks), left in .grad
    return dict(metrics=mean_over_ranks(metrics),
                controlnet=_grads(state.pipe.cldm.controlnet),
                decoder=_grads(state.pipe.cldm.vae.decoder), detnet=_grads(state.detnet),
                stats={n: b.clone() for n, b in state.detnet.named_buffers()
                       if n.endswith("running_mean") or n.endswith("running_var")})


def _grads(module) -> dict:
    return {n: p.grad.clone() for n, p in module.named_parameters() if p.grad is not None}


def swinir_pre_step(rank: int = 0, world: int = 1):
    """One SwinIR pre-training step (the tiny SwinIR, AdamW) on this
    rank's rows of a global batch of 4."""
    from edtr_torch.models.layers import randomize_
    from edtr_torch.models.swinir import SwinIR
    from edtr_torch.parallel.distributed import mean_over_ranks
    from edtr_torch.train import recipes as R

    net = randomize_(SwinIR(embed_dim=16, depths=(2,), num_heads=(2,), window_size=4,
                            mlp_ratio=2, sf=8), _gen(6))
    state = R.SimpleTrainState.create(net, R.cosine_tx("adamw", 1e-3, 10, weight_decay=0.0))
    g = np.random.default_rng(7)
    lq = torch.as_tensor(g.random((GLOBAL_BATCH, IMAGE, IMAGE, 3)), dtype=torch.float32)
    gt = torch.as_tensor(g.random((GLOBAL_BATCH, IMAGE, IMAGE, 3)), dtype=torch.float32)
    m = GLOBAL_BATCH // world
    rows = slice(rank * m, (rank + 1) * m)
    metrics = R.make_swinir_pre_train_step(net)(state, dict(lq=lq[rows], gt=gt[rows]))
    return dict(metrics=mean_over_ranks(metrics), grads=_grads(net))


def runner_case(rank: int, config: str, swinir_config: str):
    """``edtr_train`` (its config at two microbatches, with validation) and
    ``task_train``'s SwinIR pre-training in ``--debug`` on the CPU at the
    tiny widths: which rank saved, the validation stats each rank
    computed, and the trained weights."""
    import edtr_torch.train.runner as PR
    from edtr_torch.utils import checkpoint as ckpt

    PR.DTYPE, PR.IMG_SIZE = None, IMAGE
    sys.modules["torch.utils.tensorboard"] = None
    saves, vals = [], []
    real, real_val = ckpt.save_submodules, PR.V.log_val_stats

    def save(*a, **kw):
        saves.append(sorted(a[1]))
        return real(*a, **kw)

    def log_val(logger, writer, step, stats):
        vals.append(dict(stats))
        return real_val(logger, writer, step, stats)

    ckpt.save_submodules, PR.V.log_val_stats = save, log_val
    state = PR.edtr_train(config, debug=True, device="cpu")
    edtr = dict(saves=list(saves), step=state.step, vals=vals,
                controlnet_sq=sum(float(p.detach().square().sum())
                                  for p in state.pipe.cldm.controlnet.parameters()))
    saves.clear()
    sw = PR.task_train(swinir_config, "det", recipe="swinir-pre", debug=True, device="cpu")
    return dict(edtr=edtr, swinir=dict(saves=list(saves), params={
        n: p.detach().clone() for n, p in sw.module.named_parameters()}))


def main(phase: str, rank: int, port: str, out: str, *configs: str) -> None:
    os.environ.update(EDTR_COORDINATOR=f"localhost:{port}", EDTR_NUM_PROCESSES=str(WORLD),
                      EDTR_PROCESS_ID=str(rank))
    torch.set_num_threads(1)
    from edtr_torch.parallel.distributed import maybe_initialize_distributed, process_rank

    res = dict(multi=maybe_initialize_distributed(), rank=process_rank(),
               backend=torch.distributed.get_backend())
    if phase == "a":
        from edtr_torch.train.harness import make_dataloader
        from edtr_torch.utils.coco_eval import CocoEvaluator

        ev = CocoEvaluator(coco_gt())
        ev.update(coco_shard(rank))
        ev.synchronize_between_processes()
        ev.accumulate()
        res["coco"] = dict(ids=sorted(ev.dt), stats=ev.summarize(verbose=False))
        res["loaders"] = [[[int(i) for i in b[2]] for b in make_dataloader(
            Range(kw["n"]), batch_size=kw["batch_size"], shuffle=True, seed=kw["seed"])]
            for kw in LOADERS]
        res["tp"] = tp_case(rank)
        res["fsdp"] = fsdp_case(rank)
    else:
        res["det"] = {accum: det_step(rank, WORLD, accum) for accum in DET_ACCUM}
        res["swinir_pre"] = swinir_pre_step(rank, WORLD)
        res["runner"] = runner_case(rank, *configs)
    torch.save(res, os.path.join(out, f"{phase}-{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), *sys.argv[3:])
