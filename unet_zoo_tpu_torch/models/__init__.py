"""Model registry: ``create_model`` / ``list_models`` / ``get_model_config``.

Counterpart of ``unet_zoo_tpu/models/__init__.py``: the same 28 names,
``ModelSpec`` metadata and keyword precedence.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch
from torch import nn

from unet_zoo_tpu_torch.models.attention_unet import AttentionUNet
from unet_zoo_tpu_torch.models.da_transformer import DATransformer, get_da_transformer_config
from unet_zoo_tpu_torch.models.egeunet import EGEUNet
from unet_zoo_tpu_torch.models.medt_net import MedTLoGo, ResAxialAttentionUNet
from unet_zoo_tpu_torch.models.missformer import MISSFormer
from unet_zoo_tpu_torch.models.mmunet import MMUNet
from unet_zoo_tpu_torch.models.multiresunet import MultiResUnet
from unet_zoo_tpu_torch.models.nested_unet import NestedUNet
from unet_zoo_tpu_torch.models.raunet import RAUNet
from unet_zoo_tpu_torch.models.resunet import ResUnet
from unet_zoo_tpu_torch.models.swin_unet_v2 import SwinUNetV2
from unet_zoo_tpu_torch.models.transatt_unet import TransAttUNet
from unet_zoo_tpu_torch.models.u2net import U2Net
from unet_zoo_tpu_torch.models.u2net_tpu import U2NetTPU
from unet_zoo_tpu_torch.models.uctransnet import UCTransNet, get_uctransnet_config
from unet_zoo_tpu_torch.models.unet import UNet
from unet_zoo_tpu_torch.models.unet_tpu import UNetTPU
from unet_zoo_tpu_torch.models.unet_transformer import UTransformer
from unet_zoo_tpu_torch.models.unext import UNext
from unet_zoo_tpu_torch.models.vnet import VNet
from unet_zoo_tpu_torch.models.wranet import WRANet
from unet_zoo_tpu_torch.nn import init_weights
from unet_zoo_tpu_torch.utils import pretrained as pretrained_weights


class ConfigDict(dict):
    """Attribute-access dict; ``get_model_config`` returns these."""

    def __getattr__(self, key):
        try:
            v = self[key]
        except KeyError as e:
            raise AttributeError(key) from e
        return ConfigDict(v) if isinstance(v, dict) and not isinstance(v, ConfigDict) else v

    def __setattr__(self, key, value):
        self[key] = value


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Declarative per-model metadata attached to a registry entry."""

    name: str
    build: Callable[..., nn.Module]
    requires_image_size: bool = False
    default_image_size: Optional[int] = None
    # Per-output-key loss weights; absent keys get 1.0 for 'main' and
    # `default_aux_weight` otherwise.
    loss_weights: Mapping[str, float] = dataclasses.field(default_factory=dict)
    default_aux_weight: float = 0.5
    config_fn: Optional[Callable[..., Any]] = None
    # pretrained_loader(weights_path) -> overlay(module) or None: file-based
    # pretrained weights, put over the freshly drawn ones (raunet's encoder)
    pretrained_loader: Optional[Callable[[Optional[str]], Any]] = None
    # entries that load their pretrained weights when create_model's
    # ``pretrained`` is left unspecified (raunet, whose original constructor
    # always loads its encoder)
    pretrained_by_default: bool = False

    def loss_weight(self, key: str) -> float:
        if key in self.loss_weights:
            return self.loss_weights[key]
        return 1.0 if key == "main" else self.default_aux_weight


_REGISTRY: Dict[str, ModelSpec] = {}


def register_model(name: str, **spec_kwargs):
    """Decorator registering a build function under ``name``."""

    def deco(build_fn: Callable[..., nn.Module]) -> Callable[..., nn.Module]:
        _REGISTRY[name] = ModelSpec(name=name, build=build_fn, **spec_kwargs)
        return build_fn

    return deco


def list_models() -> List[str]:
    """All available model names, sorted."""
    return sorted(_REGISTRY.keys())


def get_model_config(model_name: str, **kwargs) -> Dict[str, Any]:
    """Default config for models that carry one; empty otherwise."""
    spec = _REGISTRY.get(model_name.lower())
    if spec is not None and spec.config_fn is not None:
        return ConfigDict(spec.config_fn(**kwargs))
    return ConfigDict()


@dataclasses.dataclass
class ZooModel:
    """Thin handle around a model's ``nn.Module`` and its registry entry.

    ``module(x)`` takes NCHW images and returns ``{'main': logits, ...}``.
    """

    name: str
    module: nn.Module
    spec: ModelSpec
    in_channels: int
    num_classes: int
    image_size: Optional[int]

    def loss_weight(self, key: str) -> float:
        return self.spec.loss_weight(key)


def _resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; CUDA must exist when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def create_model(model_name: str, pretrained: Optional[bool] = None,
                 **kwargs) -> ZooModel:
    """Instantiate a zoo model by name.

    ``in_channels`` (3), ``num_classes`` (1), ``image_size`` and ``depth``
    (5) as in the JAX registry; the remaining kwargs go to the model, user
    values winning over defaults. ``pretrained`` None takes the entry's
    default (True for raunet alone); ``weights_path`` names a pretrained file
    for the entry's loader (raunet: a torchvision resnet34 ``.pth``).
    Port-specific: ``dtype`` (compute type,
    ``torch.float32`` or ``torch.bfloat16``), ``device`` (default
    ``"cuda"``; raises when CUDA is absent, never falls back to the CPU),
    ``seed`` (weights drawn from a ``torch.Generator`` on the CPU, so one
    seed gives the same weights on every device) and ``use_kernels``, also
    spelt ``use_pallas`` as in the YAML configs (``None``: kernels in eval on
    CUDA; ``False``: plain modules). The module comes back in eval mode,
    in ``channels_last`` memory, on ``device``.
    """
    key = model_name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown model: '{model_name}'. Available models: {list_models()}")
    spec = _REGISTRY[key]
    if pretrained is None:
        pretrained = spec.pretrained_by_default

    in_channels = kwargs.pop("in_channels", 3)
    num_classes = kwargs.pop("num_classes", 1)
    image_size = kwargs.pop("image_size", None)
    depth = kwargs.pop("depth", 5)
    dtype = kwargs.pop("dtype", torch.float32)
    device = _resolve_device(kwargs.pop("device", "cuda"))
    seed = kwargs.pop("seed", 0)
    weights_path = kwargs.pop("weights_path", None)
    if "use_pallas" in kwargs:
        if "use_kernels" in kwargs:
            raise ValueError("pass use_kernels or use_pallas, not both")
        kwargs["use_kernels"] = kwargs.pop("use_pallas")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")

    if spec.requires_image_size and image_size is None:
        raise ValueError(f"Model '{model_name}' requires 'image_size' parameter in config.")
    if image_size is None:
        image_size = spec.default_image_size

    module = spec.build(in_channels=in_channels, num_classes=num_classes,
                        image_size=image_size, depth=depth, dtype=dtype, **kwargs)
    init_weights(module, torch.Generator().manual_seed(seed))
    if pretrained:
        if spec.pretrained_loader is None:
            print(f"Warning: Pre-trained weights for {model_name} are not yet implemented.")
        else:
            overlay = spec.pretrained_loader(weights_path)
            if overlay is not None:
                overlay(module)
    module = module.to(device=device, memory_format=torch.channels_last).eval()
    return ZooModel(name=key, module=module, spec=spec, in_channels=in_channels,
                    num_classes=num_classes, image_size=image_size)


def _raunet_pretrained_loader(weights_path: Optional[str] = None
                              ) -> Optional[Callable[[nn.Module], None]]:
    """The overlay of RAUNet's pretrained encoder, resolved as JAX's
    ``_raunet_pretrained_loader`` resolves it: ``weights_path`` (a
    torchvision resnet34 ``.pth``), then ``$UNET_ZOO_RESNET34`` (such a
    file), then the JAX package's vendored synthetic-pretrained encoder
    (``utils/pretrained.py`` decodes it); None (random init, with a warning)
    when none exists."""
    if weights_path is None:
        weights_path = os.environ.get("UNET_ZOO_RESNET34") or None
        if weights_path and not os.path.exists(weights_path):
            print(f"Warning: $UNET_ZOO_RESNET34={weights_path} does not exist; ignoring.")
            weights_path = None
    if weights_path is not None:
        return lambda module: _overlay_encoder(
            module, pretrained_weights.torchvision_encoder(weights_path))
    path = pretrained_weights.VENDORED_RAUNET_ENCODER
    if not os.path.exists(path):
        print("Warning: 'raunet' pretrained=True found no weights - pass "
              "weights_path=<torchvision resnet34 .pth> or set $UNET_ZOO_RESNET34. "
              "Using random init.")
        return None

    def overlay(module: nn.Module) -> None:
        sd, meta = pretrained_weights.vendored_encoder(path)
        print("raunet: using the vendored synthetic-pretrained encoder "
              f"({os.path.basename(path)}; task={meta.get('task', '?')}). For the "
              "original zoo's ImageNet init, pass weights_path=<torchvision resnet34 .pth> "
              "or set $UNET_ZOO_RESNET34.")
        _overlay_encoder(module, sd)

    return overlay


@torch.no_grad()
def _overlay_encoder(module: nn.Module, encoder: Mapping[str, torch.Tensor]) -> None:
    """Copy ``encoder`` (the port's encoder keys) over ``module``'s own
    parameters and running statistics, in their float32; every key must be
    the module's, at its shape, and every encoder parameter and statistic
    must be given."""
    own = module.state_dict()
    want = {k for k in own if k.startswith(("firstconv.", "firstbn.", "encoder"))
            and not k.endswith("num_batches_tracked")}
    if set(encoder) != want:
        raise ValueError(f"pretrained encoder keys differ from the model's: missing "
                         f"{sorted(want - set(encoder))[:5]}, unexpected "
                         f"{sorted(set(encoder) - want)[:5]}")
    for k, v in encoder.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"pretrained encoder weight {k} shape {tuple(v.shape)} does not "
                             f"match model {tuple(own[k].shape)}")
        own[k].copy_(v)


# --- registrations -----------------------------------------------------------


@register_model("unet")
def _build_unet(in_channels, num_classes, image_size, depth, dtype, **kw):
    return UNet(in_channels=in_channels, num_classes=num_classes, dtype=dtype, **kw)


@register_model("attention_unet")
def _build_attention_unet(in_channels, num_classes, image_size, depth, dtype, **kw):
    return AttentionUNet(in_channels=in_channels, num_classes=num_classes, depth=depth,
                         dtype=dtype, **kw)


@register_model("nested_unet")
def _build_nested_unet(in_channels, num_classes, image_size, depth, dtype, **kw):
    return NestedUNet(in_channels=in_channels, num_classes=num_classes,
                      deep_supervision=kw.pop("deep_supervision", False), dtype=dtype, **kw)


@register_model("resunet")
def _build_resunet(in_channels, num_classes, image_size, depth, dtype, **kw):
    return ResUnet(in_channels=in_channels, num_classes=num_classes,
                   filters=tuple(kw.pop("filters", (64, 128, 256, 512))), dtype=dtype, **kw)


@register_model("transatt_unet")
def _build_transatt_unet(in_channels, num_classes, image_size, depth, dtype, **kw):
    return TransAttUNet(in_channels=in_channels, num_classes=num_classes,
                        bilinear=kw.pop("bilinear", True), dtype=dtype, **kw)


@register_model("unet_transformer")
def _build_unet_transformer(in_channels, num_classes, image_size, depth, dtype, **kw):
    attn_res = tuple(kw.pop("common_attn_res_for_QK_V", (64, 64)))
    return UTransformer(in_channels=in_channels, num_classes=num_classes,
                        bilinear=kw.pop("bilinear", True), attn_res=attn_res, dtype=dtype, **kw)


@register_model("multiresunet")
def _build_multiresunet(in_channels, num_classes, image_size, depth, dtype, **kw):
    return MultiResUnet(in_channels=in_channels, num_classes=num_classes,
                        filters=kw.pop("filters", 32), dtype=dtype, **kw)


# the JAX registry's unit side weights (unet_zoo_tpu/models/__init__.py:260-263, :374-376)
_U2NET_LOSS_WEIGHTS = {key: 1.0 for key in ("main", "side1", "side2", "side3", "side4",
                                            "side5", "side6")}
_U2NET_TPU_LOSS_WEIGHTS = {key: 1.0 for key in ("main", "side1", "side2", "side3", "side4")}


@register_model("u2net", loss_weights=_U2NET_LOSS_WEIGHTS)
def _build_u2net(in_channels, num_classes, image_size, depth, dtype, **kw):
    return U2Net(in_channels=in_channels, num_classes=num_classes, small=False, dtype=dtype,
                 **kw)


@register_model("u2netp", loss_weights=_U2NET_LOSS_WEIGHTS)
def _build_u2netp(in_channels, num_classes, image_size, depth, dtype, **kw):
    return U2Net(in_channels=in_channels, num_classes=num_classes, small=True, dtype=dtype,
                 **kw)


@register_model("u2net_tpu", loss_weights=_U2NET_TPU_LOSS_WEIGHTS)
def _build_u2net_tpu(in_channels, num_classes, image_size, depth, dtype, **kw):
    return U2NetTPU(in_channels=in_channels, num_classes=num_classes,
                    widths=tuple(kw.pop("widths", (128, 256, 512, 512))),
                    levels=tuple(kw.pop("levels", (2, 2, 1))), dtype=dtype, **kw)


@register_model("unet_tpu")
def _build_unet_tpu(in_channels, num_classes, image_size, depth, dtype, **kw):
    # the JAX registry's defaults (unet_zoo_tpu/models/__init__.py:359-371)
    return UNetTPU(in_channels=in_channels, num_classes=num_classes,
                   widths=tuple(kw.pop("widths", (128, 256, 512, 512))), dtype=dtype, **kw)


@register_model("mmunet")
def _build_mmunet(in_channels, num_classes, image_size, depth, dtype, **kw):
    return MMUNet(
        in_channels=in_channels, num_classes=num_classes,
        base_channels=kw.pop("base_channels", 96),
        bilinear=kw.pop("bilinear", True),
        layer_scale_init_value=kw.pop("layer_scale_init_value", 1e-6),
        se_ratio=kw.pop("se_ratio", 0.25), dtype=dtype, **kw,
    )


_MEDT_DEAD_KWARGS = ("norm_layer", "zero_init_residual", "replace_stride_with_dilation",
                     "layers", "s")


def _build_medt_family(mode, in_channels, num_classes, image_size, dtype, kw):
    # the JAX registry's defaults; the same kwargs are accepted and dropped
    for dead in _MEDT_DEAD_KWARGS:
        kw.pop(dead, None)
    return ResAxialAttentionUNet(
        mode=mode, num_classes=num_classes, in_channels=in_channels,
        img_size=image_size if image_size is not None else 128,
        groups=kw.pop("groups", 8), width_per_group=kw.pop("width_per_group", 64),
        dtype=dtype, **kw)


@register_model("axialunet", default_image_size=128)
def _build_axialunet(in_channels, num_classes, image_size, depth, dtype, pretrained=False, **kw):
    return _build_medt_family("base", in_channels, num_classes, image_size, dtype, kw)


@register_model("gated", default_image_size=128)
def _build_gated(in_channels, num_classes, image_size, depth, dtype, pretrained=False, **kw):
    return _build_medt_family("gated", in_channels, num_classes, image_size, dtype, kw)


@register_model("medt", default_image_size=128)
def _build_medt(in_channels, num_classes, image_size, depth, dtype, pretrained=False, **kw):
    return _build_medt_family("wopos", in_channels, num_classes, image_size, dtype, kw)


@register_model("logo", default_image_size=128)
def _build_logo(in_channels, num_classes, image_size, depth, dtype, pretrained=False, **kw):
    # wired as 'gated', as in the original zoo and the JAX registry
    return _build_medt_family("gated", in_channels, num_classes, image_size, dtype, kw)


@register_model("medt_logo", default_image_size=128)
def _build_medt_logo(in_channels, num_classes, image_size, depth, dtype, pretrained=False,
                     **kw):
    for dead in _MEDT_DEAD_KWARGS:
        kw.pop(dead, None)
    return MedTLoGo(
        num_classes=num_classes, in_channels=in_channels,
        img_size=image_size if image_size is not None else 128,
        groups=kw.pop("groups", 8), width_per_group=kw.pop("width_per_group", 64),
        dtype=dtype, **kw)


@register_model("swin_unet_v2", requires_image_size=True)
def _build_swin_unet_v2(in_channels, num_classes, image_size, depth, dtype, **kw):
    # the JAX registry's defaults; the same dead kwargs are accepted and dropped
    for dead in ("depths_decoder", "use_checkpoint", "final_upsample", "norm_layer"):
        kw.pop(dead, None)
    return SwinUNetV2(
        img_size=image_size, patch_size=kw.pop("patch_size", 4), in_chans=in_channels,
        num_classes=num_classes, embed_dim=kw.pop("embed_dim", 96),
        depths=tuple(kw.pop("depths", (2, 2, 2, 2))),
        num_heads=tuple(kw.pop("num_heads", (3, 6, 12, 24))),
        window_size=kw.pop("window_size", 7), mlp_ratio=kw.pop("mlp_ratio", 4.0),
        qkv_bias=kw.pop("qkv_bias", True), qk_scale=kw.pop("qk_scale", None),
        drop_rate=kw.pop("drop_rate", 0.0), attn_drop_rate=kw.pop("attn_drop_rate", 0.0),
        drop_path_rate=kw.pop("drop_path_rate", 0.1), ape=kw.pop("ape", False),
        patch_norm=kw.pop("patch_norm", True), use_mlp=kw.pop("use_mlp", False),
        dtype=dtype, **kw)


def _build_unext_family(small, in_channels, num_classes, dtype, kw):
    # the JAX registry's defaults: unext_s pins its widths and depths and
    # drops the user's; unext keeps the user's (three stages are used)
    if small:
        defaults = dict(embed_dims=(64, 128, 160), num_heads=(1, 2, 4), mlp_ratios=(4, 4, 4),
                        depths=(2, 2, 2), sr_ratios=(8, 4, 2))
        for k in defaults:
            kw.pop(k, None)
    else:
        defaults = dict(
            embed_dims=kw.pop("embed_dims", None) or (128, 160, 256),
            num_heads=kw.pop("num_heads", None) or (1, 2, 4, 8),
            mlp_ratios=kw.pop("mlp_ratios", None) or (4, 4, 4, 4),
            depths=kw.pop("depths", None) or (3, 4, 6, 3),
            sr_ratios=kw.pop("sr_ratios", None) or (8, 4, 2, 1),
        )
    kw.pop("norm_layer", None)  # accepted and dropped: LayerNorm is fixed
    return UNext(
        in_channels=in_channels, num_classes=num_classes,
        qkv_bias=kw.pop("qkv_bias", False), qk_scale=kw.pop("qk_scale", None),
        drop_rate=kw.pop("drop_rate", 0.0), attn_drop_rate=kw.pop("attn_drop_rate", 0.0),
        drop_path_rate=kw.pop("drop_path_rate", 0.0), dtype=dtype,
        **{k: tuple(v) for k, v in defaults.items()}, **kw)


@register_model("unext")
def _build_unext(in_channels, num_classes, image_size, depth, dtype, **kw):
    return _build_unext_family(False, in_channels, num_classes, dtype, kw)


@register_model("unext_s")
def _build_unext_s(in_channels, num_classes, image_size, depth, dtype, **kw):
    return _build_unext_family(True, in_channels, num_classes, dtype, kw)


@register_model("unext_moe")
def _build_unext_moe(in_channels, num_classes, image_size, depth, dtype, **kw):
    # unext_s with every other MiT block's FFN a Switch-MoE (nn/moe.py), as in JAX
    kw.setdefault("moe_experts", 4)
    return _build_unext_family(True, in_channels, num_classes, dtype, kw)


@register_model("wranet")
def _build_wranet(in_channels, num_classes, image_size, depth, dtype, **kw):
    return WRANet(in_channels=in_channels, num_classes=num_classes,
                  feature_channels=kw.pop("feature_channels", 128), dtype=dtype, **kw)


@register_model("raunet", pretrained_loader=_raunet_pretrained_loader,
                pretrained_by_default=True)
def _build_raunet(in_channels, num_classes, image_size, depth, dtype, **kw):
    kw.pop("use_kernels", None)   # no kernel on its path
    return RAUNet(in_channels=in_channels, num_classes=num_classes, dtype=dtype, **kw)


@register_model("vnet")
def _build_vnet(in_channels, num_classes, image_size, depth, dtype, **kw):
    kw.pop("use_kernels", None)   # no kernel on its path
    return VNet(in_channels=in_channels, num_classes=num_classes, elu=kw.pop("elu", True),
                nll=kw.pop("nll", False), dtype=dtype, **kw)


@register_model("missformer", default_image_size=512)
def _build_missformer(in_channels, num_classes, image_size, depth, dtype, **kw):
    # the JAX registry's entry: two reference kwargs accepted and dropped; the
    # layers do not depend on the image size
    kw.pop("token_mlp_mode", None)
    kw.pop("encoder_pretrained", None)
    return MISSFormer(in_channels=in_channels, num_classes=num_classes, dtype=dtype, **kw)


@register_model("egeunet", default_image_size=512)
def _build_egeunet(in_channels, num_classes, image_size, depth, dtype, **kw):
    kw.pop("use_kernels", None)   # no kernel on its path
    return EGEUNet(in_channels=in_channels, num_classes=num_classes,
                   c_list=kw.pop("c_list", None), bridge=kw.pop("bridge", True),
                   gt_ds=kw.pop("gt_ds", True),
                   image_size=image_size if image_size is not None else 512, dtype=dtype, **kw)


@register_model("da_transformer", config_fn=get_da_transformer_config)
def _build_da_transformer(in_channels, num_classes, image_size, depth, dtype, **kw):
    # only the ResNet's depth and width reach the model, as in JAX
    config = kw.pop("config", None) or get_da_transformer_config()
    return DATransformer(in_channels=in_channels, num_classes=num_classes,
                         block_units=tuple(config["resnet"]["num_layers"]),
                         width_factor=config["resnet"]["width_factor"], dtype=dtype, **kw)


@register_model("uctransnet", requires_image_size=True, config_fn=get_uctransnet_config)
def _build_uctransnet(in_channels, num_classes, image_size, depth, dtype, **kw):
    kw.pop("use_kernels", None)   # no kernel on its path
    config = kw.pop("config", None) or get_uctransnet_config()
    vis = kw.pop("vis", config.get("vis", False))
    return UCTransNet(in_channels=in_channels, num_classes=num_classes, image_size=image_size,
                      vis=vis, base_channel=config["base_channel"],
                      patch_sizes=tuple(config["patch_sizes"]),
                      num_layers=config["transformer"]["num_layers"],
                      num_heads=config["transformer"]["num_heads"],
                      expand_ratio=config["expand_ratio"], dtype=dtype, **kw)


__all__ = [
    "ModelSpec",
    "ZooModel",
    "create_model",
    "get_model_config",
    "list_models",
    "register_model",
]
