"""Weight bridge: ``edtr_tpu`` parameter trees -> the port's state dicts.

The inverse of ``edtr_tpu/utils/convert.py``'s ``convert_ldm_unet``,
``convert_controlnet``, ``convert_autoencoder_kl``, ``convert_swinir``,
``convert_clip_text``, ``convert_mobilenetv3`` (the classifier too),
``convert_fasterrcnn_mobilenet``, ``convert_fasterrcnn_resnet50_v2``,
``convert_resnet``, ``convert_deeplabv3_mobilenet`` (and DeepLabV3 on
ResNet) and ``convert_lpips`` (AlexNet and VGG16), written without
importing them: a JAX tree (nested dicts of numpy arrays, flax
names, HWIO conv kernels, (in, out) dense kernels) becomes a state dict
under the reference LDM/SD or torchvision key names, which the port's
modules load with ``load_state_dict(strict=True)``. The task nets (the
detector, MobileNetV3, ResNet, DeepLabV3) take full flax variables, ``{"params", "batch_stats"}``: the
BatchNorm ``mean``/``var`` become ``running_mean``/``running_var``. The
CLIP text tower's keys are OpenCLIP's (``cond_stage_model.model.*`` of an
SD2.1 checkpoint without that prefix), its q/k/v kernels fused again into
the reference's ``in_proj_weight``/``in_proj_bias``.
:func:`pipeline_from_jax` converts a whole pipeline's tree
(``swinir``, ``unet``, ``controlnet``, ``vae``, ``clip``) at once.

:func:`strip_swinir_lanes` undoes ``edtr_tpu.utils.convert.pad_swinir_lanes``
(the JAX flagship's 180 -> 192 lane padding) so a padded tree loads into
the unpadded port.
"""

from __future__ import annotations

import itertools
import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

Tree = Mapping[str, Any]

_LEAF = [(r"/(kernel|scale)$", "/weight")]

# (pattern, replacement) over the '/'-joined flax path, applied in order
_RULES = {
    "unet": [
        (r"^time_embed_(\d)/", r"time_embed/\1/"),
        (r"^(input|output)_blocks_(\d+)_(\d+)/", r"\1_blocks/\2/\3/"),
        (r"^middle_block_(\d)/", r"middle_block/\1/"),
        (r"^middle_block_out/", "middle_block_out/0/"),
        (r"^zero_convs_(\d+)/", r"zero_convs/\1/0/"),
        (r"^out_norm/", "out/0/"),
        (r"^out_conv/", "out/2/"),
        (r"/in_norm/", "/in_layers/0/"),
        (r"/in_conv/", "/in_layers/2/"),
        (r"/emb_proj/", "/emb_layers/1/"),
        (r"/out_norm/", "/out_layers/0/"),
        (r"/out_conv/", "/out_layers/3/"),
        (r"/skip/", "/skip_connection/"),
        (r"/blocks_(\d+)/", r"/transformer_blocks/\1/"),
        (r"/to_out/", "/to_out/0/"),
        (r"/ff/proj/", "/ff/net/0/proj/"),
        (r"/ff/out/", "/ff/net/2/"),
    ] + _LEAF,
    "vae": [
        (r"/down_(\d+)_block_(\d+)/", r"/down/\1/block/\2/"),
        (r"/down_(\d+)_downsample/", r"/down/\1/downsample/"),
        (r"/up_(\d+)_block_(\d+)/", r"/up/\1/block/\2/"),
        (r"/up_(\d+)_upsample/", r"/up/\1/upsample/"),
        (r"/mid_(block_\d|attn_\d)/", r"/mid/\1/"),
    ] + _LEAF,
    "swinir": [
        (r"^conv_first_1/", "conv_first/1/"),
        (r"^patch_embed_norm/", "patch_embed/norm/"),
        (r"^layers_(\d+)/blocks_(\d+)/", r"layers/\1/residual_group/blocks/\2/"),
        (r"^layers_(\d+)/", r"layers/\1/"),
        (r"^conv_before_upsample_0/", "conv_before_upsample/0/"),
    ] + _LEAF,
}
_RULES["controlnet"] = _RULES["unet"]
_MOBILENET = [
    (r"(^|/)features_(\d+)/", r"\1features/\2/"),
    (r"/block_(\d+)/", r"/block/\1/"),
    (r"/conv/", "/0/"),
    (r"/bn/", "/1/"),
]
_STATS = [(r"/mean$", "/running_mean"), (r"/var$", "/running_var")]
_RULES["mobilenetv3"] = _MOBILENET + [(r"^classifier_(\d)/", r"classifier/\1/")] + _LEAF + _STATS
_RESNET = [(r"(^|/)layer(\d)_(\d+)/", r"\1layer\2/\3/"), (r"/downsample_(\d)/", r"/downsample/\1/")]
_RULES["resnet"] = _RESNET + _LEAF + _STATS
# DeepLabV3 on either backbone: the heads' rules run first (they consume
# their "/conv/" and "/bn/"); ASPP's branch 4 is the pooling one (three
# atrous rates), whose conv and norm sit at 1 and 2 after the pooling
_RULES["deeplabv3"] = [
    (r"^classifier/aspp/convs_4/conv/", "classifier/0/convs/4/1/"),
    (r"^classifier/aspp/convs_4/bn/", "classifier/0/convs/4/2/"),
    (r"^classifier/aspp/convs_(\d)/", r"classifier/0/convs/\1/"),
    (r"^classifier/aspp/project/", "classifier/0/project/"),
    (r"^(aux_classifier|classifier)/out/", r"\1/4/"),
    (r"^classifier/head/conv/", "classifier/1/"),
    (r"^classifier/head/bn/", "classifier/2/"),
    (r"^aux_classifier/head/conv/", "aux_classifier/0/"),
    (r"^aux_classifier/head/bn/", "aux_classifier/1/"),
    (r"^backbone/features_(\d+)/", r"backbone/\1/"),
] + _RESNET + _MOBILENET[1:] + _LEAF + _STATS
# the body's rules run first (MobileNet's or ResNet-50's): the RPN's names
# gain a "/conv/" of their own; the v2's FPN norms sit at 1 after each conv,
# its box head's convs and norms at {j}.0 / {j}.1 and its fc at 5
_RULES["fasterrcnn"] = [(r"^body/", "backbone/body/")] + _MOBILENET + _RESNET + [
    (r"^fpn/(inner|layer)_bn_(\d+)/", r"backbone/fpn/\1_blocks/\2/1/"),
    (r"^fpn/inner_(\d+)/", r"backbone/fpn/inner_blocks/\1/0/"),
    (r"^fpn/layer_(\d+)/", r"backbone/fpn/layer_blocks/\1/0/"),
    (r"^rpn_head/conv_(\d+)/", r"rpn/head/conv/\1/0/"),
    (r"^rpn_head/", "rpn/head/"),
    (r"^box_head/conv_(\d)/", r"roi_heads/box_head/\1/0/"),
    (r"^box_head/bn_(\d)/", r"roi_heads/box_head/\1/1/"),
    (r"^box_head/fc/", "roi_heads/box_head/5/"),
    (r"^box_(head|predictor)/", r"roi_heads/box_\1/"),
] + _LEAF + _STATS
# the models whose trees are full variables, {"params", "batch_stats"}
_VARIABLES = ("mobilenetv3", "fasterrcnn", "resnet", "deeplabv3")
# the box head's first fc (the MobileNet's fc6, the v2's 5) reads pooled
# RoIs (256, 7, 7) flattened channel-major in the port (torchvision) and
# spatial-major in JAX
_FC6 = ("roi_heads.box_head.fc6.weight", "roi_heads.box_head.5.weight")
_POOLED = (7, 7, 256)
# the lpips package's towers: torchvision feature indices inside each
# slice (``net.slice{s}.{i}``) of JAX's ``conv{ci}``, AlexNet's five and
# VGG16's thirteen convs
LPIPS_CONVS = {
    "alex": ("slice1.0", "slice2.3", "slice3.6", "slice4.8", "slice5.10"),
    "vgg": ("slice1.0", "slice1.2", "slice2.5", "slice2.7", "slice3.10", "slice3.12",
            "slice3.14", "slice4.17", "slice4.19", "slice4.21", "slice5.24", "slice5.26",
            "slice5.28"),
}


def _leaves(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    for name, node in tree.items():
        path = f"{prefix}{name}"
        if isinstance(node, Mapping):
            yield from _leaves(node, path + "/")
        else:
            yield path, np.asarray(node)


def _tensor(value) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))


def _clip_from_jax(tree: Tree) -> Dict[str, torch.Tensor]:
    """The OpenCLIP text keys of a JAX ``CLIPTextEncoder`` tree."""
    def norm(prefix, node):
        return {f"{prefix}.weight": _tensor(node["scale"]), f"{prefix}.bias": _tensor(node["bias"])}

    def linear(prefix, node):
        return {f"{prefix}.weight": _tensor(np.asarray(node["kernel"]).T),
                f"{prefix}.bias": _tensor(node["bias"])}

    out = {"token_embedding.weight": _tensor(tree["token_embedding"]),
           "positional_embedding": _tensor(tree["positional_embedding"]),
           **norm("ln_final", tree["ln_final"])}
    blocks = sorted(int(k.rsplit("_", 1)[1]) for k in tree if k.startswith("resblocks_"))
    for i in blocks:
        node, p = tree[f"resblocks_{i}"], f"transformer.resblocks.{i}"
        proj = [node[f"{n}_proj"] for n in "qkv"]
        out.update(norm(f"{p}.ln_1", node["ln_1"]))
        out[f"{p}.attn.in_proj_weight"] = _tensor(
            np.concatenate([np.asarray(m["kernel"]).T for m in proj]))
        out[f"{p}.attn.in_proj_bias"] = _tensor(np.concatenate([np.asarray(m["bias"])
                                                                for m in proj]))
        out.update(linear(f"{p}.attn.out_proj", node["out_proj"]))
        out.update(norm(f"{p}.ln_2", node["ln_2"]))
        out.update(linear(f"{p}.mlp.c_fc", node["c_fc"]))
        out.update(linear(f"{p}.mlp.c_proj", node["c_proj"]))
    return out


def pipeline_from_jax(params: Tree) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``EDTRPipeline`` from a JAX pipeline's
    parameter tree: ``swinir.*`` and ``cldm.{unet,controlnet,vae,clip}.*``,
    each group the tree holds."""
    out = {}
    for group in ("swinir", "unet", "controlnet", "vae", "clip"):
        if group in params:
            prefix = "swinir." if group == "swinir" else f"cldm.{group}."
            out.update({prefix + k: v for k, v in from_jax(params[group], group).items()})
    return out


def _lpips_from_jax(tree: Tree, net: str) -> Dict[str, torch.Tensor]:
    """The ``lpips`` package's keys of a JAX ``LPIPS`` tree (the inverse of
    ``convert_lpips``): the tower's convs at ``net.slice{s}.{i}``, the 1x1
    heads at ``lin{i}.model.1.weight`` (the fixed scaling layer has no
    learned entry)."""
    out = {}
    for ci, loc in enumerate(LPIPS_CONVS[net]):
        node = tree["tower"][f"conv{ci}"]
        out[f"net.{loc}.weight"] = _tensor(np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
        out[f"net.{loc}.bias"] = _tensor(node["bias"])
    for i in range(5):
        out[f"lin{i}.model.1.weight"] = _tensor(
            np.asarray(tree[f"lin{i}"]["kernel"]).transpose(3, 2, 0, 1))
    return out


def from_jax(tree: Tree, model: str) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``model`` ("unet", "controlnet", "vae",
    "swinir", "clip", "mobilenetv3", "fasterrcnn" (either variant),
    "resnet", "deeplabv3" (on either backbone), "lpips" or "lpips-vgg")
    from that model's ``edtr_tpu`` parameter tree (for "mobilenetv3",
    "fasterrcnn", "resnet" and "deeplabv3" its full variables)."""
    if model == "clip":
        return _clip_from_jax(tree)
    if model in ("lpips", "lpips-vgg"):
        return _lpips_from_jax(tree, "vgg" if model == "lpips-vgg" else "alex")
    rules = _RULES[model]
    leaves = _leaves(tree)
    if model in _VARIABLES:
        leaves = itertools.chain(_leaves(tree["params"]), _leaves(tree["batch_stats"]))
    out = {}
    for path, value in leaves:
        key = path
        for pattern, repl in rules:
            key = re.sub(pattern, repl, key)
        if path.endswith("/kernel"):
            # HWIO -> OIHW conv kernels, (in, out) -> (out, in) dense kernels
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
        out[key.replace("/", ".")] = _tensor(value)
    for fc in _FC6:
        if fc in out:
            w = out[fc]
            out[fc] = w.reshape(-1, *_POOLED).permute(0, 3, 1, 2).reshape(w.shape).contiguous()
    return out


def strip_swinir_lanes(tree: Tree, lane_pad: int = 12, heads: int = 6) -> Dict[str, Any]:
    """Inverse of ``pad_swinir_lanes``: cut a SwinIR tree padded from C to
    C + ``lane_pad`` channels back to C. The residual stream was padded at
    the end of the channel axis, attention q/k/v and the proj input per
    head (channel h*d_new + j holds h*d + j)."""
    cp = np.asarray(tree["conv_after_body"]["kernel"]).shape[-1]
    c = cp - lane_pad
    d, d_new = c // heads, cp // heads

    def heads_cut(a, axis, segs):
        a = np.asarray(a)
        shp = list(a.shape)
        shp[axis:axis + 1] = [segs, heads, d_new]
        a = np.take(a.reshape(shp), np.arange(d), axis=axis + 2)
        shp = list(a.shape)
        shp[axis:axis + 3] = [segs * heads * d]
        return a.reshape(shp)

    def cut(a, *sizes):  # leading axes cut to the given sizes (None: keep)
        a = np.asarray(a)
        return a[tuple(slice(None) if s is None else slice(0, s) for s in sizes)]

    out: Dict[str, Any] = {}
    for key, node in tree.items():
        if key in ("patch_embed_norm", "norm"):
            out[key] = {k: cut(v, c) for k, v in node.items()}
        elif key in ("conv_first", "conv_first_1"):
            out[key] = {"kernel": cut(node["kernel"], None, None, None, c),
                        "bias": cut(node["bias"], c)}
        elif key == "conv_after_body":
            out[key] = {"kernel": cut(node["kernel"], None, None, c, c),
                        "bias": cut(node["bias"], c)}
        elif key == "conv_before_upsample_0":
            out[key] = {"kernel": cut(node["kernel"], None, None, c),
                        "bias": np.asarray(node["bias"])}
        elif key.startswith("layers_"):
            layer = {}
            for bkey, bnode in node.items():
                if bkey == "conv":
                    layer[bkey] = {"kernel": cut(bnode["kernel"], None, None, c, c),
                                   "bias": cut(bnode["bias"], c)}
                    continue
                attn, mlp = bnode["attn"], bnode["mlp"]
                h_new = np.asarray(mlp["fc1"]["kernel"]).shape[1]
                hidden = h_new * c // cp
                qkv = {"kernel": heads_cut(cut(attn["qkv"]["kernel"], c), 1, 3)}
                if "bias" in attn["qkv"]:
                    qkv["bias"] = heads_cut(attn["qkv"]["bias"], 0, 3)
                layer[bkey] = {
                    "norm1": {k: cut(v, c) for k, v in bnode["norm1"].items()},
                    "norm2": {k: cut(v, c) for k, v in bnode["norm2"].items()},
                    "attn": {
                        "qkv": qkv,
                        "proj": {"kernel": cut(heads_cut(attn["proj"]["kernel"], 0, 1),
                                               None, c),
                                 "bias": cut(attn["proj"]["bias"], c)},
                        "relative_position_bias_table":
                            np.asarray(attn["relative_position_bias_table"]),
                    },
                    "mlp": {
                        "fc1": {"kernel": cut(mlp["fc1"]["kernel"], c, hidden),
                                "bias": cut(mlp["fc1"]["bias"], hidden)},
                        "fc2": {"kernel": cut(mlp["fc2"]["kernel"], hidden, c),
                                "bias": cut(mlp["fc2"]["bias"], c)},
                    },
                }
            out[key] = layer
        else:
            out[key] = node
    return out
