"""Weights from the JAX package into the port.

``from_jax_variables(model_name, variables)`` takes a JAX variables tree
``{'params', 'batch_stats'}`` (leaves as numpy arrays, or anything
``np.asarray`` reads) and returns a ``state_dict`` that the port's module
loads with ``strict=True``. It is the inverse of the JAX package's
``utils/convert.py`` readers, kept as the port's own copy:

* conv: HWIO -> OIHW;
* ConvTranspose: Flax applies the kernel spatially flipped, so
  ``torch_w = flip(flax_k, axes 0, 1).transpose(2, 3, 0, 1)``;
* BatchNorm: scale/bias/mean/var -> weight/bias/running_mean/running_var;
* Dense -> ``nn.Linear``: ``kernel.T``; Dense -> ``nn.Conv1d(k=1)``:
  ``kernel.T[:, :, None]``;
* a grouped conv keeps the conv rule: [3, 3, 2, C] -> [C, 2, 3, 3];
* MedT's qkv Dense -> ``qkv_transform.conv`` (``Conv1d`` k=1):
  ``kernel.T[:, :, None]``; ``relative`` and the scalar gates as they are;
* UNext: ``DWConv_0.dwconv`` -> ``mlp.dwconv.dwconv`` (the grouped conv rule),
  ``attn.sr_norm`` -> ``attn.norm``; unext_moe's ``moe_mlp`` (the router and
  the expert-stacked FFN) one to one, JAX's names and shapes;
* missformer: the inverse of the JAX package's ``convert_missformer``
  (``utils/convert.py:576``), so the original zoo's names: ``DWConv_0.dwconv``
  -> ``mlp.dwconv.dwconv``, a bridge layer's ``attn.sr{i}``/``attn.sr_norm`` ->
  ``attn.scale_reduce.sr_convs.{i}``/``attn.scale_reduce.norm``;
* WRANet: ``alpha`` [1, 1, 1, C] -> [1, C, 1, 1]; the deformable weight
  [k, k, C, O] (HWIO) -> ``rdb.convs.0.conv.weight`` [O, C, k, k];
* LayerNorm: scale/bias -> weight/bias; SwinV2's ``tau`` and
  ``absolute_pos_embed`` as they are; its ``cpb_fc1``/``cpb_fc2`` ->
  ``cpb.fc1``/``cpb.fc2`` and ``mlp_fc1``/``mlp_fc2`` -> ``mlp.fc1``/``mlp.fc2``;
* unet_tpu and u2net_tpu: the JAX names kept (``stem``, ``stem_bn``,
  ``enc{i}``, ``down{i}``, ``bottleneck``, ``dec{i}``, the heads); a
  ``ConvNormAct``'s ``Conv_0``/``BatchNorm_0`` -> ``conv``/``bn``;
* attention_unet, nested_unet, u2net/u2netp and resunet: the inverses of the
  JAX package's ``convert_attention_unet``, ``convert_nested_unet``,
  ``convert_u2net`` and ``convert_resunet`` (``utils/convert.py:104-213``),
  so the original zoo's names (``conv{i}.conv.{0,1,3,4}``, ``up{i}.up.{1,2}``,
  ``att{i}.{w_g,w_x,psi}.{0,1}``, ``conv{r}_{c}.{conv1,bn1,conv2,bn2}``,
  ``stage{n}[d].rebnconv*.{conv_s1,bn_s1}``, ``input_layer.{0,1,3}``,
  ``conv_block.{0,2,3,5}``, ``conv_skip.{0,1}``, ``upsample_{i}.upsample``);
  attention_unet's depth is read from the variables (JAX's converter
  assumes 5).

``quant_from_jax(model_name, quant)`` takes the ``quant`` collection that the
JAX package's ``calibrate_int8`` adds (each gated conv's ``in_absmax``) and
returns the port's int8 statistics, ``{conv module name: absmax}``, as
``utils.serving.calibrate_int8`` returns them, so both sides serve the same
calibrated int8 model.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a contiguous, writable copy


def _conv(sd, key, p):
    sd[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _conv_transpose(sd, key, p):
    sd[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"])[::-1, ::-1], (2, 3, 0, 1)))
    sd[f"{key}.bias"] = _t(p["bias"])


def _bn(sd, key, p, s):
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])
    sd[f"{key}.running_mean"] = _t(s["mean"])
    sd[f"{key}.running_var"] = _t(s["var"])
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _double_conv(sd, prefix, p, s):
    for i, idx in enumerate((0, 3)):
        cna, st = p[f"ConvNormAct_{i}"], s[f"ConvNormAct_{i}"]
        _conv(sd, f"{prefix}.{idx}", cna["Conv_0"])
        _bn(sd, f"{prefix}.{idx + 1}", cna["BatchNorm_0"], st["BatchNorm_0"])


def _unet(variables) -> Dict[str, torch.Tensor]:
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for i in range(4):
        _double_conv(sd, f"down_convolution_{i + 1}.conv.conv_op",
                     p[f"DownSample_{i}"]["DoubleConv_0"], s[f"DownSample_{i}"]["DoubleConv_0"])
    _double_conv(sd, "bottle_neck.conv_op", p["DoubleConv_0"], s["DoubleConv_0"])
    for i in range(4):
        up_p, up_s = p[f"UpSampleUNet_{i}"], s[f"UpSampleUNet_{i}"]
        _conv_transpose(sd, f"up_convolution_{i + 1}.up",
                        up_p["TransposedUp_0"]["ConvTranspose_0"])
        _double_conv(sd, f"up_convolution_{i + 1}.conv.conv_op",
                     up_p["DoubleConv_0"], up_s["DoubleConv_0"])
    _conv(sd, "out.conv", p["OutConv_0"]["Conv_0"])
    return sd


def _unet_tpu(variables) -> Dict[str, torch.Tensor]:
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "stem", p["stem"])
    _bn(sd, "stem_bn", p["stem_bn"], s["stem_bn"])
    for name in p:
        if name.startswith(("enc", "dec")) or name == "bottleneck":
            _double_conv(sd, f"{name}.conv_op", p[name], s[name])
        elif name.startswith("down"):
            _conv(sd, f"{name}.conv", p[name]["Conv_0"])
            _bn(sd, f"{name}.bn", p[name]["BatchNorm_0"], s[name]["BatchNorm_0"])
    _conv(sd, "head_dts" if "head_dts" in p else "head", p.get("head_dts", p.get("head")))
    return sd


def _cna(sd, key, conv_key, bn_key, p, s):
    """A JAX ``ConvNormAct`` (``Conv_0``, ``BatchNorm_0``) -> ``{key}.{conv_key}``,
    ``{key}.{bn_key}``."""
    _conv(sd, f"{key}.{conv_key}", p["Conv_0"])
    _bn(sd, f"{key}.{bn_key}", p["BatchNorm_0"], s["BatchNorm_0"])


def _attention_unet(variables) -> Dict[str, torch.Tensor]:
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    depth = sum(1 for k in p if k.startswith("conv") and k[4:].isdigit())
    for i in range(1, depth + 1):
        _double_conv(sd, f"conv{i}.conv", p[f"conv{i}"], s[f"conv{i}"])
    for i in range(depth, 1, -1):
        _cna(sd, f"up{i}.up", "1", "2", p[f"up{i}"]["ConvNormAct_0"],
             s[f"up{i}"]["ConvNormAct_0"])
        a, sa = p[f"att{i}"], s[f"att{i}"]
        for j, name in enumerate(("w_g", "w_x", "psi")):
            _conv(sd, f"att{i}.{name}.0", a[f"Conv_{j}"])
            _bn(sd, f"att{i}.{name}.1", a[f"BatchNorm_{j}"], sa[f"BatchNorm_{j}"])
        _double_conv(sd, f"upconv{i}.conv", p[f"upconv{i}"], s[f"upconv{i}"])
    _conv(sd, "conv_1x1", p["conv_1x1"])
    return sd


def _nested_unet(variables) -> Dict[str, torch.Tensor]:
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for name in p:
        if name.startswith("final"):
            _conv(sd, name, p[name])
        else:
            for i in (1, 2):
                _cna(sd, name, f"conv{i}", f"bn{i}", p[name][f"ConvNormAct_{i - 1}"],
                     s[name][f"ConvNormAct_{i - 1}"])
    return sd


def _u2net(variables) -> Dict[str, torch.Tensor]:
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for name in p:
        if name.startswith("stage"):
            for blk in p[name]:
                _cna(sd, f"{name}.{blk}", "conv_s1", "bn_s1", p[name][blk], s[name][blk])
        else:
            _conv(sd, name, p[name])
    return sd


RESUNET_BLOCKS = ("residual_conv_1", "residual_conv_2", "bridge", "up_residual_conv1",
                  "up_residual_conv2", "up_residual_conv3")


def _resunet(variables) -> Dict[str, torch.Tensor]:
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "input_layer.0", p["Conv_0"])
    _bn(sd, "input_layer.1", p["BatchNorm_0"], s["BatchNorm_0"])
    _conv(sd, "input_layer.3", p["Conv_1"])
    _conv(sd, "input_skip.0", p["Conv_2"])
    for i, name in enumerate(RESUNET_BLOCKS):
        rp, rs = p[f"ResidualConv_{i}"], s[f"ResidualConv_{i}"]
        for bn, key in (("BatchNorm_0", "conv_block.0"), ("BatchNorm_1", "conv_block.3"),
                        ("BatchNorm_2", "conv_skip.1")):
            _bn(sd, f"{name}.{key}", rp[bn], rs[bn])
        for cv, key in (("Conv_0", "conv_block.2"), ("Conv_1", "conv_block.5"),
                        ("Conv_2", "conv_skip.0")):
            _conv(sd, f"{name}.{key}", rp[cv])
    for i in range(3):
        _conv_transpose(sd, f"upsample_{i + 1}.upsample", p[f"TransposedUp_{i}"]["ConvTranspose_0"])
    _conv(sd, "output_layer.0", p["Conv_3"])
    return sd


def _u2net_tpu(variables) -> Dict[str, torch.Tensor]:
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "stem", p["stem"])
    _bn(sd, "stem_bn", p["stem_bn"], s["stem_bn"])
    for name, sub in p.items():
        if name.startswith(("enc", "dec")) or name == "bottleneck":
            for cna in sub:
                _cna(sd, f"{name}.{cna}", "conv", "bn", sub[cna], s[name][cna])
        elif name.startswith("down"):
            _cna(sd, name, "conv", "bn", sub, s[name])
        elif name.startswith(("side", "outconv")):
            _conv(sd, name, sub)
    return sd


def _dense(sd, key, p):
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _mkblock(sd, prefix, p, s):
    for i in (1, 2, 3):
        _conv(sd, f"{prefix}.dwconv{i}", p[f"dwconv{i}"])
        _bn(sd, f"{prefix}.norm{i}", p[f"norm{i}"], s[f"norm{i}"])
    _bn(sd, f"{prefix}.norm4", p["norm4"], s["norm4"])
    _dense(sd, f"{prefix}.pwconv1", p["pwconv1"])
    _dense(sd, f"{prefix}.pwconv2", p["pwconv2"])
    if "norm_ea" in p:
        _bn(sd, f"{prefix}.norm_ea", p["norm_ea"], s["norm_ea"])
        _conv(sd, f"{prefix}.conv1", p["conv1"])
        for name in ("linear_0", "linear_1"):
            sd[f"{prefix}.{name}.weight"] = _t(np.asarray(p[name]["kernel"]).T[:, :, None])
        _conv(sd, f"{prefix}.conv2.0", p["conv2"])
        _bn(sd, f"{prefix}.conv2.1", p["conv2_bn"], s["conv2_bn"])


def _mmunet(variables) -> Dict[str, torch.Tensor]:
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for name in ("first_down", "down0", "down0_1", "down1", "down2", "down3"):
        _conv(sd, f"{name}.0", p[f"{name}_conv"])
        _bn(sd, f"{name}.1", p[f"{name}_bn1"], s[f"{name}_bn1"])
        _mkblock(sd, f"{name}.2", p[f"{name}_blk1"], s[f"{name}_blk1"])
        _bn(sd, f"{name}.3", p[f"{name}_bn2"], s[f"{name}_bn2"])
        _mkblock(sd, f"{name}.4", p[f"{name}_blk2"], s[f"{name}_blk2"])
    for u in (1, 2, 3, 4):
        up, us = p[f"up{u}"], s[f"up{u}"]
        if "mlp_fc1" in up:
            _conv(sd, f"up{u}.mlp.fc1", up["mlp_fc1"])
            _conv(sd, f"up{u}.mlp.fc2", up["mlp_fc2"])
        _conv(sd, f"up{u}.linear1", up["linear1"])
        _conv(sd, f"up{u}.conv.0", up["fuse_conv"])
        _bn(sd, f"up{u}.conv.1", up["fuse_bn"], us["fuse_bn"])
        _mkblock(sd, f"up{u}.conv.2", up["blk1"], us["blk1"])
        _mkblock(sd, f"up{u}.conv.3", up["blk2"], us["blk2"])
    for i in (1, 2):
        _mkblock(sd, f"up5.conv.{i - 1}", p[f"up5_blk{i}"], s[f"up5_blk{i}"])
    _conv(sd, "eam.up_x2.1", p["efm_conv"])
    _bn(sd, "eam.up_x2.2", p["efm_bn"], s["efm_bn"])
    _conv(sd, "eam.linear1", p["efm_linear1"])
    _conv(sd, "out_conv.0", p["out_conv"])
    return sd


def _axial_attention(sd, prefix, p, s):
    # Dense [in, out] -> Conv1d(k=1) weight [out, in, 1]
    sd[f"{prefix}.qkv_transform.conv.weight"] = _t(np.asarray(p["qkv"]["kernel"]).T[:, :, None])
    for name in ("bn_qkv", "bn_similarity", "bn_output"):
        _bn(sd, f"{prefix}.{name}", p[name], s[name])
    for name in ("relative", "f_qr", "f_kr", "f_sv", "f_sve"):   # absent for wopos
        if name in p:
            sd[f"{prefix}.{name}"] = _t(p[name])


def _axial_block(sd, prefix, p, s):
    _conv(sd, f"{prefix}.conv_down", p["conv_down"])
    _bn(sd, f"{prefix}.bn1", p["bn1"], s["bn1"])
    for name in ("hight_block", "width_block"):
        _axial_attention(sd, f"{prefix}.{name}", p[name], s[name])
    _conv(sd, f"{prefix}.conv_up", p["conv_up"])
    _bn(sd, f"{prefix}.bn2", p["bn2"], s["bn2"])
    if "downsample_conv" in p:
        _conv(sd, f"{prefix}.downsample.0", p["downsample_conv"])
        _bn(sd, f"{prefix}.downsample.1", p["downsample_bn"], s["downsample_bn"])


def _axial_stages(sd, p, s, names):
    for name in names:
        bi = 0
        while f"{name}_{bi}" in p:
            _axial_block(sd, f"{name}.{bi}", p[f"{name}_{bi}"], s[f"{name}_{bi}"])
            bi += 1


def _stem(sd, p, s, suffix):
    for c in (1, 2, 3):
        _conv(sd, f"conv{c}{suffix}", p[f"conv{c}"])
        _bn(sd, f"bn{c}{suffix}", p[f"bn{c}"], s[f"bn{c}"])


def _medt_family(variables) -> Dict[str, torch.Tensor]:
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _stem(sd, p, s, "")
    _axial_stages(sd, p, s, ("layer1", "layer2", "layer3", "layer4"))
    for d in (1, 2, 3, 4):
        _conv(sd, f"decoder{d}", p[f"decoder{d}"])
    _conv(sd, "final_conv", p["final_conv"])
    return sd


def _medt_logo(variables) -> Dict[str, torch.Tensor]:
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _stem(sd, p["stem"], s["stem"], "")
    _stem(sd, p["stem_p"], s["stem_p"], "_p")
    _axial_stages(sd, p, s, ("layer1", "layer2", "layer1_p", "layer2_p", "layer3_p",
                             "layer4_p"))
    for name in ("decoder4", "decoder5", "decoder1_p", "decoder2_p", "decoder3_p",
                 "decoder4_p", "decoder5_p", "decoderf", "adjust"):
        _conv(sd, name, p[name])
    return sd


def _ln(sd, key, p):
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


def _swin_block(sd, prefix, p):
    a = p["attn"]
    for name, key in (("qkv", "qkv"), ("proj", "proj"), ("cpb_fc1", "cpb.fc1"),
                      ("cpb_fc2", "cpb.fc2")):
        _dense(sd, f"{prefix}.attn.{key}", a[name])
    sd[f"{prefix}.attn.tau"] = _t(a["tau"])
    _ln(sd, f"{prefix}.norm1", p["norm1"])
    if "mlp_fc1" in p:                                   # use_mlp=True
        _dense(sd, f"{prefix}.mlp.fc1", p["mlp_fc1"])
        _dense(sd, f"{prefix}.mlp.fc2", p["mlp_fc2"])
        _ln(sd, f"{prefix}.norm2", p["norm2"])


def _swin_blocks(sd, prefix, p, name):
    i = 0
    while f"{name}_blk{i}" in p:
        _swin_block(sd, f"{prefix}.blocks.{i}", p[f"{name}_blk{i}"])
        i += 1


def _patch_resize(sd, key, p, linear):
    _dense(sd, f"{key}.{linear}", p[linear])
    _ln(sd, f"{key}.norm", p["norm"])


def _swin_unet_v2(variables) -> Dict[str, torch.Tensor]:
    p = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "patch_embed.proj", p["patch_embed"])
    if "patch_norm" in p:
        _ln(sd, "patch_embed.norm", p["patch_norm"])
    if "absolute_pos_embed" in p:
        sd["absolute_pos_embed"] = _t(p["absolute_pos_embed"])
    nl = 0
    while f"layer{nl}_blk0" in p:
        _swin_blocks(sd, f"layers.{nl}", p, f"layer{nl}")
        if f"layer{nl}_downsample" in p:
            _patch_resize(sd, f"layers.{nl}.downsample", p[f"layer{nl}_downsample"], "reduction")
        nl += 1
    _patch_resize(sd, "layers_up.0", p["layer_up0"], "expand")
    for u in range(1, nl):
        _swin_blocks(sd, f"layers_up.{u}", p, f"layer_up{u}")
        if f"layer_up{u}_upsample" in p:
            _patch_resize(sd, f"layers_up.{u}.upsample", p[f"layer_up{u}_upsample"], "expand")
        _dense(sd, f"concat_back_dim.{u}", p[f"concat_back_dim{u}"])
    _ln(sd, "norm", p["norm"])
    _ln(sd, "norm_up", p["norm_up"])
    _patch_resize(sd, "up", p["up"], "expand")
    _conv(sd, "output", p["output"])
    return sd


def _unext(variables) -> Dict[str, torch.Tensor]:
    p = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for s in (1, 2, 3):
        _conv(sd, f"patch_embed{s}.proj", p[f"patch_embed{s}"]["proj"])
        _ln(sd, f"patch_embed{s}.norm", p[f"patch_embed{s}"]["norm"])
        i = 0
        while f"block{s}_{i}" in p:
            blk, t = p[f"block{s}_{i}"], f"block{s}.{i}"
            _ln(sd, f"{t}.norm1", blk["norm1"])
            _ln(sd, f"{t}.norm2", blk["norm2"])
            for name in ("q", "kv", "proj"):
                _dense(sd, f"{t}.attn.{name}", blk["attn"][name])
            if "sr" in blk["attn"]:
                _conv(sd, f"{t}.attn.sr", blk["attn"]["sr"])
                _ln(sd, f"{t}.attn.norm", blk["attn"]["sr_norm"])
            if "moe_mlp" in blk:                          # unext_moe: one to one
                for name, a in blk["moe_mlp"].items():
                    sd[f"{t}.moe_mlp.{name}"] = _t(a)
            else:
                _dense(sd, f"{t}.mlp.fc1", blk["mlp"]["fc1"])
                _conv(sd, f"{t}.mlp.dwconv.dwconv", blk["mlp"]["DWConv_0"]["dwconv"])
                _dense(sd, f"{t}.mlp.fc2", blk["mlp"]["fc2"])
            i += 1
        _ln(sd, f"norm{s}", p[f"norm{s}"])
    for d in (1, 2, 3):
        _conv(sd, f"decoder_level{d}", p[f"decoder_level{d}"])
    _conv(sd, "final_conv", p["final_conv"])
    return sd


def _mixffn(sd, t, p):
    _dense(sd, f"{t}.fc1", p["fc1"])
    _conv(sd, f"{t}.dwconv.dwconv", p["DWConv_0"]["dwconv"])
    _ln(sd, f"{t}.norm1", p["norm1"])
    _dense(sd, f"{t}.fc2", p["fc2"])


def _mf_block(sd, t, p):
    _ln(sd, f"{t}.norm1", p["norm1"])
    _ln(sd, f"{t}.norm2", p["norm2"])
    for name in ("q", "kv", "proj"):
        _dense(sd, f"{t}.attn.{name}", p["attn"][name])
    if "sr" in p["attn"]:
        _conv(sd, f"{t}.attn.sr", p["attn"]["sr"])
        _ln(sd, f"{t}.attn.norm", p["attn"]["sr_norm"])
    _mixffn(sd, f"{t}.mlp", p["mlp"])


def _missformer(variables) -> Dict[str, torch.Tensor]:
    p = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    bb = p["backbone"]
    for s in (1, 2, 3, 4):
        _conv(sd, f"backbone.patch_embed{s}.proj", bb[f"patch_embed{s}"]["proj"])
        _ln(sd, f"backbone.patch_embed{s}.norm", bb[f"patch_embed{s}"]["norm"])
        i = 0
        while f"block{s}_{i}" in bb:
            _mf_block(sd, f"backbone.block{s}.{i}", bb[f"block{s}_{i}"])
            i += 1
        _ln(sd, f"backbone.norm{s}", bb[f"norm{s}"])
    br = p["bridge"]
    for li in (1, 2, 3, 4):
        layer, t = br[f"bridge_layer{li}"], f"bridge.bridge_layer{li}"
        _ln(sd, f"{t}.norm1", layer["norm1"])
        _ln(sd, f"{t}.norm2", layer["norm2"])
        for c in (1, 2, 3, 4):
            if f"proj_c{c}" in layer:
                _dense(sd, f"{t}.proj_c{c}", layer[f"proj_c{c}"])
        a = layer["attn"]
        for name in ("q", "kv", "proj"):
            _dense(sd, f"{t}.attn.{name}", a[name])
        _ln(sd, f"{t}.attn.scale_reduce.norm", a["sr_norm"])
        for i in (0, 1, 2):
            _conv(sd, f"{t}.attn.scale_reduce.sr_convs.{i}", a[f"sr{i}"])
        for m in (1, 2, 3, 4):
            _mixffn(sd, f"{t}.mixffn{m}", layer[f"mixffn{m}"])
    for c in (1, 2, 3, 4):
        _dense(sd, f"bridge.proj_back_c{c}", br[f"proj_back_c{c}"])
    for d in (3, 2, 1, 0):
        dp, t = p[f"decoder_{d}"], f"decoder_{d}"
        if "concat_linear" in dp:
            _dense(sd, f"{t}.concat_linear", dp["concat_linear"])
        for name in ("layer_former_1", "layer_former_2"):
            _mf_block(sd, f"{t}.{name}", dp[name])
        _dense(sd, f"{t}.layer_up.expand", dp["layer_up"]["expand"])
        _ln(sd, f"{t}.layer_up.norm", dp["layer_up"]["norm"])
        if "last_layer" in dp:
            _conv(sd, f"{t}.last_layer", dp["last_layer"])
    return sd


def _wranet(variables) -> Dict[str, torch.Tensor]:
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "convblock_1.0", p["stem1"])
    _conv(sd, "convblock_1.1", p["stem2"])
    for e in (1, 2, 3):
        wp, t = p[f"enc{e}_wrarb"], f"encoder_block_{e}.lite_wragb"
        for si, nb in enumerate((1, 2, 3, 4)):
            for bi in range(nb):
                _conv(sd, f"{t}.streams.{si}.{bi}.dw_conv", wp[f"stream{si}_b{bi}"]["dw"])
                _conv(sd, f"{t}.streams.{si}.{bi}.conv_1x1", wp[f"stream{si}_b{bi}"]["pw"])
        _conv(sd, f"{t}.project.0", wp["project"]["Conv_0"])
        _conv(sd, f"{t}.ag.0", wp["ag0"])
        _conv(sd, f"{t}.ag.2", wp["ag1"])
        sd[f"{t}.alpha"] = _t(np.transpose(np.asarray(wp["alpha"]), (0, 3, 1, 2)))
        _conv(sd, f"encoder_block_{e}.conv_3x3.0", p[f"enc{e}_conv"]["Conv_0"])
    _conv(sd, "down1", p["down1"])
    _conv(sd, "down2", p["down2"])
    for lv in (2, 1):
        t = f"decoder_lv{lv}"
        dp, ds = p[t], s[t]
        _conv(sd, f"{t}.pixelshuffle_block.0", dp["ps_conv"])
        _conv(sd, f"{t}.conv_3x3_last.0", dp["conv_3x3_last"]["Conv_0"])
        _bn(sd, f"{t}.conv_3x3_last.1", dp["conv_3x3_last"]["BatchNorm_0"],
            ds["conv_3x3_last"]["BatchNorm_0"])
        deform = dp["rdb"]["deform"]
        _conv(sd, f"{t}.rdb.convs.0.offset_conv", deform["offset_conv"])
        _conv(sd, f"{t}.rdb.convs.0.modulator_conv", deform["modulator_conv"])
        _conv(sd, f"{t}.rdb.convs.0.conv", {"kernel": deform["weight"],
                                            **({"bias": deform["bias"]} if "bias" in deform
                                               else {})})
        _conv(sd, f"{t}.rdb.last_conv", dp["rdb"]["last_conv"])
    for i in (1, 2, 3):
        _conv(sd, f"last_conv.{i - 1}", p[f"last{i}"])
    return sd


CONVERTERS: Dict[str, Callable[[Any], Dict[str, torch.Tensor]]] = {
    "attention_unet": _attention_unet, "axialunet": _medt_family, "gated": _medt_family,
    "logo": _medt_family, "medt": _medt_family, "medt_logo": _medt_logo,
    "missformer": _missformer, "mmunet": _mmunet,
    "nested_unet": _nested_unet, "resunet": _resunet, "swin_unet_v2": _swin_unet_v2,
    "u2net": _u2net, "u2net_tpu": _u2net_tpu, "u2netp": _u2net, "unet": _unet,
    "unet_tpu": _unet_tpu, "unext": _unext, "unext_moe": _unext, "unext_s": _unext,
    "wranet": _wranet}


def from_jax_variables(model_name: str, variables) -> Dict[str, torch.Tensor]:
    """JAX variables ``{'params', 'batch_stats'}`` (``{'params'}`` alone for
    a model without BatchNorm) -> the port's ``state_dict``."""
    name = model_name.lower()
    if name not in CONVERTERS:
        raise ValueError(f"No converter for '{model_name}'. Available: {sorted(CONVERTERS)}")
    return CONVERTERS[name](variables)


def _absmax(out, key, q):
    if "in_absmax" in q:
        out[key] = _t(q["in_absmax"]).reshape(())


def _double_conv_quant(out, prefix, q):
    for i, idx in enumerate((0, 3)):
        _absmax(out, f"{prefix}.{idx}", q.get(f"ConvNormAct_{i}", {}))


def _unet_quant(q) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for i in range(4):
        _double_conv_quant(out, f"down_convolution_{i + 1}.conv.conv_op",
                           q.get(f"DownSample_{i}", {}).get("DoubleConv_0", {}))
        _double_conv_quant(out, f"up_convolution_{i + 1}.conv.conv_op",
                           q.get(f"UpSampleUNet_{i}", {}).get("DoubleConv_0", {}))
    _double_conv_quant(out, "bottle_neck.conv_op", q.get("DoubleConv_0", {}))
    return out


def _unet_tpu_quant(q) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name, sub in q.items():
        if name.startswith("down"):
            _absmax(out, f"{name}.conv", sub)
        else:
            _double_conv_quant(out, f"{name}.conv_op", sub)
    return out


def _attention_unet_quant(q) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name, sub in q.items():
        if name.startswith("up") and not name.startswith("upconv"):
            _absmax(out, f"{name}.up.1", sub.get("ConvNormAct_0", {}))
        else:
            _double_conv_quant(out, f"{name}.conv", sub)
    return out


def _nested_unet_quant(q) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name, sub in q.items():
        for i in (1, 2):
            _absmax(out, f"{name}.conv{i}", sub.get(f"ConvNormAct_{i - 1}", {}))
    return out


QUANT_CONVERTERS: Dict[str, Callable[[Any], Dict[str, torch.Tensor]]] = {
    "attention_unet": _attention_unet_quant, "nested_unet": _nested_unet_quant,
    "unet": _unet_quant, "unet_tpu": _unet_tpu_quant}


def quant_from_jax(model_name: str, quant) -> Dict[str, torch.Tensor]:
    """The JAX ``quant`` collection (``variables['quant']`` after
    ``calibrate_int8``) -> the port's int8 statistics {conv name: absmax}.
    A conv the JAX forward did not reach (a fused decoder stage) has none."""
    name = model_name.lower()
    if name not in QUANT_CONVERTERS:
        raise ValueError(f"No int8 converter for '{model_name}'. "
                         f"Available: {sorted(QUANT_CONVERTERS)}")
    return QUANT_CONVERTERS[name](quant)
