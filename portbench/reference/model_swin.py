"""The plain reference of PCTrans over a Swin backbone: ``swin.py``'s
backbone composed with the reference's MSDeformAttn pixel decoder and
position-guided masked decoder (``model.py``), which stay as they are.

``SwinModelConfig`` adds the ``MODEL.SWIN`` sizes to the recipe's; the
weights are ``model.init_weights``' for the decoders, and for the backbone
one more normal draw on the same generator: LeCun normal (N(0, 1/fan_in))
for the attention projections and the patch embedding and N(0, 0.02) for
the MLPs and the merges' reductions, as the JAX initializers draw them
(untruncated here), and N(0, 1) for the relative-position tables, whose
trained values span several units (the initializer's 0.02 would leave the
bias out of what a comparison sees); zero biases, identity norms.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .config import ModelConfig
from .model import PRECISIONS, PCTransReference, _fp8_conv, _fp8_linear, init_weights
from .pixel_decoder import MSDeformAttnPixelDecoder
from .swin import SwinTransformer, WindowAttention
from .transformer_decoder import MultiScaleMaskedTransformerDecoder


@dataclasses.dataclass(frozen=True)
class SwinModelConfig(ModelConfig):
    backbone_name: str = "D2SwinTransformer"
    swin_embed_dim: int = 96
    swin_depths: Tuple[int, ...] = (2, 2, 6, 2)
    swin_num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    swin_window_size: int = 7
    swin_drop_path: float = 0.3


_LECUN = (".qkv", ".proj", "patch_embed")


@torch.no_grad()
def init_backbone(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """The backbone's weights, drawn as the module's docstring says."""
    leaves = []                                      # (leaf, scale) of one normal draw
    for name, m in model.backbone.named_modules():
        if isinstance(m, WindowAttention):
            leaves.append((m.relative_position_bias_table, 1.0))
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            leaves.append((m.weight, fan_in ** -0.5 if name.endswith(_LECUN) else 0.02))
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    device = generator.device if generator is not None else leaves[0][0].device
    flat = torch.randn(sum(w.numel() for w, _ in leaves), generator=generator, device=device)
    start = 0
    for w, scale in leaves:
        w.copy_(flat[start:start + w.numel()].view_as(w) * scale)
        start += w.numel()


class PCTransSwinReference(PCTransReference):
    def __init__(self, config: SwinModelConfig, generator: Optional[torch.Generator] = None,
                 precision: str = "config"):
        nn.Module.__init__(self)
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
        c = self.config = config
        self.precision = precision
        self.backbone = SwinTransformer(c.swin_embed_dim, c.swin_depths, c.swin_num_heads,
                                        c.swin_window_size, c.swin_drop_path)
        self.pixel_decoder = MSDeformAttnPixelDecoder(
            self.backbone.channels, conv_dim=c.conv_dim, norm=c.head_norm,
            transformer_layers=c.enc_layers, n_heads=c.nheads,
            n_points=c.enc_points, fpn_legacy_swap=c.fpn_legacy_swap)
        self.predictor = MultiScaleMaskedTransformerDecoder(
            c.conv_dim, hidden_dim=c.hidden_dim, num_queries=c.num_queries,
            nheads=c.nheads, dim_feedforward=c.dim_feedforward,
            dec_layers=c.dec_layers, mask_dim=c.mask_dim,
            points_num=c.points_num, sem_loss_on=c.sem_loss_on,
            sem_norm=c.head_norm, rel_coord=c.rel_coord,
            upsample2x=c.upsample2x)
        init_weights(self, generator)
        init_backbone(self, generator)
        if precision == "fp8":
            for m in self.modules():
                if type(m) is nn.Linear:
                    m.forward = _fp8_linear.__get__(m)
                elif type(m) is nn.Conv2d:
                    m.forward = _fp8_conv.__get__(m)

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """images: [B, H, W, 3] f32 -> the port's output dict; ``generator``
        draws the backbone's drop path in training."""
        c = self.config
        mean = torch.tensor(c.pixel_mean, device=images.device)
        std = torch.tensor(c.pixel_std, device=images.device)
        x = ((images.float() - mean) / std).permute(0, 3, 1, 2).contiguous()
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=c.dtype == "bfloat16"):
            feats = self.backbone(x, generator)
            mask_features, _, multi_scale = self.pixel_decoder(feats)
            out = self.predictor(multi_scale, mask_features)
        out["mask_features"] = mask_features.permute(0, 2, 3, 1).float()
        return out


def swin_model(config: dict, device, precision: str = "config") -> PCTransSwinReference:
    """The reference with the configuration's weights (``weights_seed``),
    made on ``device`` by one generator there: the weights the harness
    gives the program."""
    gen = torch.Generator(device=device).manual_seed(int(config["weights_seed"]))
    with torch.device(device):
        return PCTransSwinReference(SwinModelConfig.from_sizes(config["model"]),
                                    generator=gen, precision=precision)

