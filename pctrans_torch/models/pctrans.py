"""PCTrans meta-architecture (mirror of ``pctrans_tpu/models/pctrans.py:140-289``):
pixel normalisation, a backbone, a pixel decoder and a transformer
predictor, chosen by the config's names as the JAX model does (``:171-263``):

* backbone: ResNet (``build_resnet_backbone``, the recipe) or Swin
  (``D2SwinTransformer``);
* pixel decoder: ``MSDeformAttnPixelDecoder`` (the recipe; its
  ``fpn_legacy_swap`` gives the published stride-8 mask features),
  ``BasePixelDecoder`` or ``TransformerEncoderPixelDecoder``;
* predictor: the position-guided ``MultiScaleMaskedTransformerDecoder``
  (the recipe) or the DETR ``StandardTransformerDecoder`` over the encoder
  features.

``PCTransModel(config)(images [B, H, W, 3])`` returns the JAX model's dict:

  pred_masks           [B, Q, Hm, Wm]  final mask logits (compute dtype;
                                       f32 from the DETR predictor), Hm x Wm
                                       the mask features' grid (H/4 x W/4,
                                       H/8 x W/8 under the legacy swap)
  aux_masks            list of dec_layers earlier [B, Q, Hm, Wm]
  reference_points     [B, Q, 2]
  aux_reference_points list of dec_layers - 1 [B, Q, 2]
  query_emb            [B, Q, C] f32
  sem_mask             [B, Hm, Wm, 1] f32 or None
  mask_features        [B, Hm, Wm, C] f32

The DETR predictor gives ``pred_masks``, ``aux_masks``, ``pred_logits``,
``aux_logits`` and ``mask_features``.  With ``config.dtype == "bfloat16"``
the forward runs under ``torch.autocast`` in bf16 (the JAX recipe's mixed
precision): autocast puts the convolutions and projections in bf16, as
JAX's ``dtype=bfloat16`` modules are; every other dtype of the ResNet +
MSDeformAttn + PCTrans path is explicit in its module (the norms, the f32
MLP heads and ``sem_logits``, sampling locations, attention softmaxes, the
render), so CPU and CUDA autocast, whose op lists differ, run one dtype
flow.  :func:`module_dtypes` maps it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ..config import ModelConfig, validate
from ..utils import tracing
from . import graphs
from .detr_decoder import StandardTransformerDecoder
from .fpn_decoder import build_fpn_decoder
from .layers import device_constant
from .pixel_decoder import MSDeformAttn, MSDeformAttnPixelDecoder, sampling_offset_bias
from .resnet import STAGE_CHANNELS, ResNet
from .swin import SwinTransformer, WindowAttention
from .transformer_decoder import MultiScaleMaskedTransformerDecoder


class PCTransModel(nn.Module):
    def __init__(self, config: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        validate(config)
        c = self.config = config
        if c.backbone_name == "D2SwinTransformer":
            # K6 computes in bf16 only: an f32 configuration's backbone runs the twin
            self.backbone = SwinTransformer(
                c.swin_embed_dim, c.swin_depths, c.swin_num_heads, c.swin_window_size,
                drop_path_rate=c.swin_drop_path,
                attention="kernel" if c.dtype == "bfloat16" else "twin")
            channels = self.backbone.channels
        else:
            self.backbone = ResNet(c.backbone_depth, c.stride_in_1x1, c.backbone_norm)
            channels = STAGE_CHANNELS
        if c.pixel_decoder_name == "MSDeformAttnPixelDecoder":
            self.pixel_decoder = MSDeformAttnPixelDecoder(
                channels, conv_dim=c.conv_dim, norm=c.head_norm,
                transformer_layers=c.enc_layers, n_heads=c.nheads,
                n_points=c.enc_points, fpn_legacy_swap=c.fpn_legacy_swap)
            mask_channels = c.conv_dim      # the mask_dim projection is the predictor's
        else:
            self.pixel_decoder = build_fpn_decoder(
                c.pixel_decoder_name, channels, c.conv_dim, c.mask_dim, c.head_norm,
                c.nheads, c.dim_feedforward, c.enc_layers)
            mask_channels = c.mask_dim
        if c.transformer_decoder_name == "StandardTransformerDecoder":
            self.predictor = StandardTransformerDecoder(
                c.conv_dim, hidden_dim=c.hidden_dim, num_queries=c.num_queries,
                nheads=c.nheads, dim_feedforward=c.dim_feedforward,
                dec_layers=c.dec_layers + 1, mask_dim=mask_channels)
        else:
            self.predictor = MultiScaleMaskedTransformerDecoder(
                mask_channels, hidden_dim=c.hidden_dim, num_queries=c.num_queries,
                nheads=c.nheads, dim_feedforward=c.dim_feedforward,
                dec_layers=c.dec_layers, mask_dim=c.mask_dim,
                points_num=c.points_num, sem_loss_on=c.sem_loss_on,
                sem_norm=c.head_norm, rel_coord=c.rel_coord,
                upsample2x=c.upsample2x)
        init_weights(self, generator)

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """images: [B, H, W, 3] f32.  ``generator`` feeds the Swin backbone's
        drop path in train mode.  The eval forward on the card replays CUDA
        graphs where ``graphs.why_eager`` finds nothing against it
        (``models/graphs.py``).  Inside ``ops._build.twins()`` every kernel
        runs its plain twin (the kernel-vs-twin comparisons on the card)."""
        if graphs.why_eager(self, images, generator) is None:
            return graphs.run(self, images, self._forward)
        return self._forward(images, generator)

    def _forward(self, images: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        c = self.config
        mean = device_constant(tuple(c.pixel_mean), images.device)
        std = device_constant(tuple(c.pixel_std), images.device)
        images = (images.float() - mean) / std
        x = images.permute(0, 3, 1, 2).contiguous()
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.config.dtype == "bfloat16"):
            with tracing.span("model.backbone"):
                feats = (self.backbone(x, generator)
                         if isinstance(self.backbone, SwinTransformer) else self.backbone(x))
            with tracing.span("model.pixel_decoder"):
                mask_features, enc_top, multi_scale = self.pixel_decoder(feats)
            with tracing.span("model.predictor"):
                if isinstance(self.predictor, StandardTransformerDecoder):
                    out = self.predictor(enc_top, mask_features)
                else:
                    out = self.predictor(multi_scale, mask_features)
        out["mask_features"] = mask_features.permute(0, 2, 3, 1).float()
        return out


def _dtypes(out) -> List[str]:
    if isinstance(out, torch.Tensor):
        return [str(out.dtype).replace("torch.", "")] if out.is_floating_point() else []
    if isinstance(out, dict):
        return [d for k in sorted(out) for d in _dtypes(out[k])]
    if isinstance(out, (list, tuple)):
        return [d for o in out for d in _dtypes(o)]
    return []


def module_dtypes(model: nn.Module, *args, **kwargs) -> Dict[str, str]:
    """Runs ``model(*args, **kwargs)`` without grad and maps every submodule
    that ran to the dtypes of the floating tensors it returned (flattened in
    order, dict keys sorted, joined by ``,``; the calls of a module called
    more than once joined by ``|`` where they differ).  The dtype map does
    not depend on the input's size, so a small image on the CPU and on the
    card must give the same map."""
    seen: Dict[str, List[str]] = {}
    hooks = []
    for name, m in model.named_modules():
        def hook(mod, inputs, out, name=name):
            sig = ",".join(_dtypes(out))
            if sig and sig not in seen.setdefault(name, []):
                seen[name].append(sig)
        hooks.append(m.register_forward_hook(hook))
    try:
        with torch.no_grad():
            model(*args, **kwargs)
    finally:
        for h in hooks:
            h.remove()
    return {name: "|".join(sigs) for name, sigs in seen.items()}


def variance_scaling_(w: torch.Tensor, scale: float, mode: str,
                      generator: Optional[torch.Generator] = None) -> None:
    """flax ``variance_scaling(scale, mode, "truncated_normal")``: a normal
    truncated at two deviations, its deviation corrected to
    sqrt(scale / fan); fans of the flax kernel layout (a conv's receptive
    field times its input or output channels)."""
    receptive = w[0, 0].numel() if w.ndim > 2 else 1
    fan = receptive * (w.shape[1] if mode == "fan_in" else w.shape[0])
    std = math.sqrt(scale / fan) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def _trunc02_(w: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """flax ``truncated_normal(stddev=0.02)``: N(0, 0.02) cut at +-0.04."""
    nn.init.trunc_normal_(w, std=0.02, a=-0.04, b=0.04, generator=generator)


# Swin's layers by name: LeCun normal (flax's default) or truncated N(0, 0.02)
_SWIN_LECUN = (".qkv", ".proj", "patch_embed")
_SWIN_TRUNC02 = ("mlp_fc1", "mlp_fc2", "reduction")
_EMBEDDINGS = ("level_embed", "query_feat", "query_embed")


def init_weights(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Seeded random init with the JAX initializers' distributions: Kaiming
    fan-out normal for ResNet convs; LeCun normal for Swin's attention
    projections and patch embedding, truncated N(0, 0.02) for its MLPs,
    patch-merging reductions and relative-position tables;
    Xavier-uniform for every other dense layer and head conv; zero biases,
    N(0, 1) embeddings, the directional bias for sampling offsets,
    identity norms."""
    g = generator
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, WindowAttention):
                _trunc02_(m.relative_position_bias_table, g)
            if not isinstance(m, (nn.Linear, nn.Conv2d)):
                continue
            if name.startswith("backbone.") and isinstance(model.backbone, ResNet):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu", generator=g)
            elif name.startswith("backbone.") and name.endswith(_SWIN_LECUN):
                variance_scaling_(m.weight, 1.0, "fan_in", g)
            elif name.startswith("backbone.") and name.endswith(_SWIN_TRUNC02):
                _trunc02_(m.weight, g)
            elif name.endswith(("mask_head", "seg_head.0.conv", "seg_head.1.conv")):
                nn.init.kaiming_uniform_(m.weight, a=1.0, generator=g)
            elif name.endswith("sem_logits"):
                fan_in = m.weight[0].numel()
                nn.init.normal_(m.weight, std=fan_in ** -0.5, generator=g)
            else:
                nn.init.xavier_uniform_(m.weight, generator=g)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        for m in model.modules():
            if isinstance(m, MSDeformAttn):
                nn.init.zeros_(m.sampling_offsets.weight)
                m.sampling_offsets.bias.copy_(torch.from_numpy(sampling_offset_bias(
                    m.n_heads, m.n_levels, m.n_points)))
                nn.init.zeros_(m.attention_weights.weight)
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in _EMBEDDINGS:
                nn.init.normal_(p, generator=g)
        for m in model.modules():
            if getattr(m, "sem_loss_on", False):
                # prior probability 0.01 (transformer_decoder.py:258-262)
                nn.init.constant_(m.sem_logits.bias, -math.log((1 - 0.01) / 0.01))
