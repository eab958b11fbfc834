from .attention import FusedAttention, attention_reference, fused_attention, head_dim_route
from .conv_gn import (
    FusedConvGN,
    channel_stats,
    conv_gn_fused,
    conv_gn_reference,
    conv_gn_takes,
    fold_gn_affine,
)
from .groupnorm import FusedGroupNormSwish, fused_group_norm_swish, group_norm_swish_reference

__all__ = [
    "FusedAttention",
    "FusedConvGN",
    "FusedGroupNormSwish",
    "attention_reference",
    "channel_stats",
    "conv_gn_fused",
    "conv_gn_reference",
    "conv_gn_takes",
    "fold_gn_affine",
    "fused_attention",
    "fused_group_norm_swish",
    "group_norm_swish_reference",
    "head_dim_route",
]
