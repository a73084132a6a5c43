"""Attention ops, PyTorch port of transception_tpu/ops/attention.py.

  * EfficientAttention (Shen et al.): softmax(K over N), softmax(Q over d),
    out = softmax-Q · (softmax-Kᵀ V).          networks/MSTr.py:80-143
  * FactorAtt + CRPE (CoaT): softmax(K over N), out = scale·Q·(KᵀV) + CRPE.
                                                networks/MSTr.py:755-886
  * MHCA block/encoder wiring.                  networks/MSTr.py:905-993

The EfficientTransformerBlock runs its two sub-blocks through the folded
kernels of ops/kernels (ETB attention, MixFFN); an MHCA block on an
even-sided map is one call of the whole-block kernel, on an odd-sided map
(stage 4) its modules run with the linear-attention kernel. In training
the kernels without a backward are off (ops.kernels.kernel_set): the ETB
attention runs plain, the MHCA block its modules, and with the MixFFN
kernel on (ffn_flash_train) the MHCA FFN sub-block folds as the ETB's
does.
"""

from __future__ import annotations

import torch
from torch import nn

from transception_tpu_torch.ops import kernels
from transception_tpu_torch.ops.common import (
    ConvPosEnc,
    DepthwiseConv,
    LayerNorm,
    Linear,
    MixFFNSkip,
)


def efficient_linear_attention(q, k, v):
    """Shen-et-al. linear attention on (B, h, N, d): k softmaxed over N,
    q over d, out = q_s · (k_sᵀ · v); fp32 softmaxes, products accumulate
    in fp32 and round to v's dtype (ops/attention.py:33)."""
    dt = v.dtype
    ks = torch.softmax(k.float(), dim=2).to(dt)
    qs = torch.softmax(q.float(), dim=3).to(dt)
    ctx = torch.matmul(ks.transpose(-1, -2), v)
    return torch.matmul(qs, ctx)


def factorized_attention(q, k, v, scale: float):
    """CoaT factorized attention on (B, h, N, d): scale·Q·(softmax-Kᵀ·V)
    through the linear-attention kernel, the scale applied to its rounded
    output as after the Pallas kernel (ops/attention.py:58)."""
    out = kernels.linear_attention.linear_attention(q, k, v)
    return (out.float() * scale).to(v.dtype)


def merge_heads(x):
    """(B, h, N, d) -> (B, N, h*d)."""
    B, h, N, d = x.shape
    return x.transpose(1, 2).reshape(B, N, h * d)


class EfficientAttention(nn.Module):
    """Parameters of the head_count-1 linear attention (MSTr.py:80-143):
    1x1-conv QKV as Dense layers. The folded ETB kernel consumes them."""

    def __init__(self, dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.keys = Linear(dim, dim, dtype=dtype)
        self.queries = Linear(dim, dim, dtype=dtype)
        self.values = Linear(dim, dim, dtype=dtype)
        self.reprojection = Linear(dim, dim, dtype=dtype)


class EfficientTransformerBlock(nn.Module):
    """LN -> EfficientAttention -> res -> LN -> MixFFN_skip -> res
    (MSTr.py:146-173), each sub-block as one folded kernel call: the ETB
    attention kernel (norm1 + QKV + attention + reprojection + residual)
    and the MixFFN kernel with norm2 and the residual folded in."""

    def __init__(self, dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = EfficientAttention(dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = MixFFNSkip(dim, dim * 4, dtype=dtype)

    def forward(self, x, H: int, W: int):
        if H != W:
            raise ValueError("EfficientTransformerBlock needs a square map")
        a = self.attn
        x = kernels.etb_attention.etb_attention(
            x.to(self.dtype), self.norm1.weight, self.norm1.bias,
            a.queries.weight, a.queries.bias, a.keys.weight, a.keys.bias,
            a.values.weight, a.values.bias, a.reprojection.weight,
            a.reprojection.bias, self.norm1.eps)
        return self.mlp.folded(x, H, self.norm2)


class ConvRelPosEnc(nn.Module):
    """CoaT convolutional relative position encoding (MSTr.py:755-823):
    per-window depthwise convs over V's token map (head-major channels,
    'B h (H W) Ch -> B (h Ch) H W'), Hadamard with Q."""

    def __init__(self, ch_per_head: int, num_heads: int,
                 window=((3, 2), (5, 3), (7, 3)), dtype=torch.bfloat16):
        super().__init__()
        self.ch = ch_per_head
        self.splits = [heads * ch_per_head for _, heads in window]
        self.conv_list = nn.ModuleList(
            DepthwiseConv(heads * ch_per_head, win, dtype=dtype)
            for win, heads in window)

    def forward(self, q, v, H: int, W: int):
        B, h, N, Ch = q.shape
        v_img = v.transpose(1, 2).reshape(B, H, W, h * Ch)
        segs = torch.split(v_img, self.splits, dim=-1)
        conv_v = torch.cat([conv(s) for conv, s in zip(self.conv_list, segs)],
                           dim=-1)
        conv_v = conv_v.reshape(B, N, h, Ch).transpose(1, 2)
        return q * conv_v


class FactorAttConvRelPosEnc(nn.Module):
    """Factorized attention with CRPE (MSTr.py:826-886); the CRPE module is
    the encoder's shared one, passed in."""

    def __init__(self, dim: int, num_heads: int = 8, dtype=torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x, H: int, W: int, crpe: ConvRelPosEnc):
        B, N, C = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        att = factorized_attention(q, k, v, (C // h) ** -0.5)
        out = merge_heads(att + crpe(q, v, H, W))
        return self.proj(out)


class MHCABlock(nn.Module):
    """CPE -> LN -> FactorAtt(+CRPE) -> res -> LN -> MixFFN_skip -> res
    (MSTr.py:905-946, LN eps 1e-6): in eval the whole-block kernel on
    even-sided maps, else (and in training, as the JAX train model's
    mhca_block_fold=False) the unfolded path of
    ops/attention.py:366-392, whose norm2 + FFN + residual fold into the
    MixFFN kernel in the flash train mode (mhca_ffn_fold, :380-386).
    cpe/crpe are the encoder's shared modules."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: int = 3,
                 dtype=torch.bfloat16):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.factoratt_crpe = FactorAttConvRelPosEnc(dim, num_heads, dtype)
        self.norm2 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.mlp = MixFFNSkip(dim, dim * mlp_ratio, dtype=dtype)

    def forward(self, x, H: int, W: int, cpe: ConvPosEnc,
                crpe: ConvRelPosEnc):
        if not self.training and H == W and H % 2 == 0:
            # The whole block as one kernel call where the TPU ran its
            # kernel (even map sides, ops/pallas/mhca_block_kernel.py:56).
            fa = self.factoratt_crpe
            convs = crpe.conv_list
            return kernels.mhca_block.mhca_block(
                x.to(self.mlp.fc1.dtype), cpe.proj.weight, cpe.proj.bias,
                self.norm1.weight, self.norm1.bias, fa.qkv.weight,
                fa.qkv.bias, [c.weight for c in convs],
                [c.bias for c in convs], fa.proj.weight, fa.proj.bias,
                self.norm2.weight, self.norm2.bias, *self.mlp.params(),
                s=H, heads=fa.num_heads, eps1=self.norm1.eps,
                eps2=self.norm2.eps, eps=self.mlp.norm1.eps)
        x = cpe(x, H, W)
        x = x + self.factoratt_crpe(self.norm1(x), H, W, crpe)
        if self.training and kernels.active("mixffn"):
            return self.mlp.folded(x, H, self.norm2)
        return x + self.mlp(self.norm2(x), H, W)


class MHCAEncoder(nn.Module):
    """Stack of MHCABlocks sharing one CPE and one CRPE (MSTr.py:949-993).
    Input and output are (B, H, W, C) maps."""

    def __init__(self, dim: int, num_layers: int = 1, num_heads: int = 8,
                 mlp_ratio: int = 3, crpe_window=((3, 2), (5, 3), (7, 3)),
                 dtype=torch.bfloat16):
        super().__init__()
        self.cpe = ConvPosEnc(dim, 3, dtype=dtype)
        self.crpe = ConvRelPosEnc(dim // num_heads, num_heads, crpe_window,
                                  dtype=dtype)
        self.MHCA_layers = nn.ModuleList(
            MHCABlock(dim, num_heads, mlp_ratio, dtype)
            for _ in range(num_layers))

    def forward(self, x):
        B, H, W, C = x.shape
        t = x.reshape(B, H * W, C)
        for layer in self.MHCA_layers:
            t = layer(t, H, W, self.cpe, self.crpe)
        return t.reshape(B, H, W, C)
