"""Attention ops, PyTorch port of transception_tpu/ops/attention.py.

  * EfficientAttention (Shen et al.): softmax(K over N), softmax(Q over d),
    out = softmax-Q · (softmax-Kᵀ V).          networks/MSTr.py:80-143
  * FactorAtt + CRPE (CoaT): softmax(K over N), out = scale·Q·(KᵀV) + CRPE.
                                                networks/MSTr.py:755-886
  * MHCA block/encoder wiring.                  networks/MSTr.py:905-993

Each block picks its structure from the fold switches of its config
(core.config.fold_switches, passed down as `folds` and indexed by the
module's .training), as the JAX modules do from theirs:
  * EfficientTransformerBlock: the attention sub-block as the folded ETB
    kernel (K1) or norm1 -> EfficientAttention (the linear-attention kernel
    K6 with the softmax of Q) -> + x; the FFN sub-block as the MixFFN
    kernel with norm2 and the residual folded in (K2) or norm2 ->
    MixFFN_skip -> + x (ops/attention.py:146-215);
  * MHCABlock: the whole block as one kernel (K5) where it takes the map
    (even sides within the TPU kernel's working-set budget), or
    its modules with the factorized attention through K6, whose FFN
    sub-block folds into K2 with mhca_ffn_fold (with drop path active it
    runs through the unfolded MixFFN kernel, K9, instead) (:300-392).
In training the switches resolve as the JAX train step's: with
use_pallas_train as in eval, else every attention unfolded and the FFN
folds only with ffn_flash_train. An MHCA block whose drop-path rate is
above 0 runs unfolded in training, its two residual branches through
drop_path.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from transception_tpu_torch.core.config import DEFAULT_FOLDS, Folds
from transception_tpu_torch.ops import kernels
from transception_tpu_torch.ops.common import (
    MLPFFN,
    ConvPosEnc,
    DepthwiseConv,
    LayerNorm,
    Linear,
    MixFFNSkip,
    make_ffn,
)
from transception_tpu_torch.parallel.mesh import global_rand


def drop_path(x: torch.Tensor, rate: float, training: bool,
              gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth on a residual branch (ops/attention.py:76-85): in
    training, each sample kept with probability 1 - rate (a Bernoulli
    mask drawn from `gen`, a torch.Generator on x's device) and rescaled,
    x · mask / keep with keep in x's dtype, as jnp divides by the Python
    float; the identity in eval or at rate 0. Under data parallelism the
    mask is this rank's rows of the global batch's (global_rand)."""
    if not training or rate == 0.0:
        return x
    if gen is None:
        raise ValueError("drop_path in training needs a torch.Generator "
                         "(the train step's gen)")
    keep = 1.0 - rate
    u = global_rand((x.shape[0],) + (1,) * (x.dim() - 1), gen, x.device)
    mask = (u < keep).to(x.dtype)
    return x * mask / torch.tensor(keep, dtype=x.dtype, device=x.device)


def efficient_linear_attention(q, k, v):
    """Shen-et-al. linear attention on (B, h, N, d): k softmaxed over N,
    q over d, out = q_s · (k_sᵀ · v); fp32 softmaxes, products accumulate
    in fp32 and round to v's dtype (ops/attention.py:33). The plain XLA
    path, where the JAX gate refuses the kernel (the bridge's channel
    attention: 6076 tokens exceed the TPU kernel's VMEM)."""
    dt = v.dtype
    ks = torch.softmax(k.float(), dim=2).to(dt)
    qs = torch.softmax(q.float(), dim=3).to(dt)
    ctx = torch.matmul(ks.transpose(-1, -2), v)
    return torch.matmul(qs, ctx)


def factorized_attention(q, k, v, scale: float):
    """CoaT factorized attention on (B, h, N, d): scale·Q·(softmax-Kᵀ·V)
    through the linear-attention kernel, the scale applied to the fp32
    product before its one rounding (ops/attention.py:68-73, the XLA path
    the JAX package takes at every MHCA head dim)."""
    return kernels.linear_attention.linear_attention(q, k, v, scale=scale)


def merge_heads(x):
    """(B, h, N, d) -> (B, N, h*d)."""
    B, h, N, d = x.shape
    return x.transpose(1, 2).reshape(B, N, h * d)


class EfficientAttention(nn.Module):
    """Head_count-1 linear attention (MSTr.py:80-143): 1x1-conv QKV as
    Dense layers, softmax_d(Q)·(softmax_N(K)ᵀ·V) through the
    linear-attention kernel, reprojection (ops/attention.py:100-125). The
    folded ETB kernel consumes the same parameters."""

    def __init__(self, dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.keys = Linear(dim, dim, dtype=dtype)
        self.queries = Linear(dim, dim, dtype=dtype)
        self.values = Linear(dim, dim, dtype=dtype)
        self.reprojection = Linear(dim, dim, dtype=dtype)

    def forward(self, x):
        q, k, v = (m(x).unsqueeze(1) for m in (self.queries, self.keys,
                                                 self.values))
        out = kernels.linear_attention.linear_attention(q, k, v,
                                                        q_softmax=True)
        return self.reprojection(merge_heads(out))


class EfficientTransformerBlock(nn.Module):
    """LN -> EfficientAttention -> res -> LN -> FFN -> res (MSTr.py:
    146-173), the FFN of token_mlp (make_ffn; JAX ops/attention.py:
    199-212). With etb_attn_fold the attention sub-block is one call of the
    folded ETB kernel (norm1 + QKV + attention + reprojection + residual),
    with etb_ffn_fold and token_mlp 'mix_skip' the FFN sub-block one call
    of the MixFFN kernel with norm2 and the residual folded in; else their
    modules. The 'mlp' FFN runs on the tokens alone, without dropout: the
    JAX block passes it no train flag (and H, W where it takes none, which
    raises there)."""

    def __init__(self, dim: int, dtype=torch.bfloat16,
                 folds: Folds = DEFAULT_FOLDS, token_mlp: str = "mix_skip"):
        super().__init__()
        self.dtype, self.folds, self.token_mlp = dtype, folds, token_mlp
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = EfficientAttention(dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = make_ffn(token_mlp, dim, dim * 4, dtype)

    def forward(self, x, H: int, W: int):
        if H != W:
            raise ValueError("EfficientTransformerBlock needs a square map")
        sw = self.folds[self.training]
        x = x.to(self.dtype)
        if sw.etb_attn:
            a = self.attn
            x = kernels.etb_attention.etb_attention(
                x, self.norm1.weight, self.norm1.bias,
                a.queries.weight, a.queries.bias, a.keys.weight, a.keys.bias,
                a.values.weight, a.values.bias, a.reprojection.weight,
                a.reprojection.bias, self.norm1.eps)
        else:
            x = x + self.attn(self.norm1(x))
        if sw.etb_ffn and self.token_mlp == "mix_skip":
            return self.mlp.folded(x, H, self.norm2)
        h = self.norm2(x)
        if isinstance(self.mlp, MLPFFN):
            return x + self.mlp(h)
        return x + self.mlp(h, H, W)


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
    (MSTr.py:905-946, LN eps 1e-6): with mhca_block_fold the whole-block
    kernel where it takes the map (kernels.mhca_block.takes), else the
    unfolded path of
    ops/attention.py:366-392, whose norm2 + FFN + residual fold into the
    MixFFN kernel with mhca_ffn_fold (:375-386). Both folds only where
    drop path is the identity (eval, or rate 0), as in JAX; otherwise the
    two branches pass drop_path, the FFN through the unfolded MixFFN
    kernel with mhca_ffn_fold (:387-391). cpe/crpe are the encoder's
    shared modules."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: int = 3,
                 dtype=torch.bfloat16, folds: Folds = DEFAULT_FOLDS,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.folds, self.drop_path_rate = folds, drop_path_rate
        self.norm1 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.factoratt_crpe = FactorAttConvRelPosEnc(dim, num_heads, dtype)
        self.norm2 = LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.mlp = MixFFNSkip(dim, dim * mlp_ratio, dtype=dtype)

    def folds_block(self, s: int) -> bool:
        """Whether this block on an s x s map is a K5 shape
        (kernels.mhca_block.takes)."""
        fc1 = self.mlp.fc1
        return kernels.mhca_block.takes(
            s, fc1.weight.shape[1], fc1.weight.shape[0],
            torch.finfo(fc1.dtype).bits // 8)

    def forward(self, x, H: int, W: int, cpe: ConvPosEnc,
                crpe: ConvRelPosEnc, gen: Optional[torch.Generator] = None):
        sw = self.folds[self.training]
        exact = not self.training or self.drop_path_rate == 0.0
        if sw.mhca_block and exact and H == W and self.folds_block(H):
            # The whole block as one kernel call where the TPU ran its
            # kernel (even map sides within its VMEM budget,
            # ops/pallas/mhca_block_kernel.py:56).
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
        def dp(t):
            return drop_path(t, self.drop_path_rate, self.training, gen)

        x = cpe(x, H, W)
        x = x + dp(self.factoratt_crpe(self.norm1(x), H, W, crpe))
        if sw.mhca_ffn and exact:
            return self.mlp.folded(x, H, self.norm2)
        return x + dp(self.mlp(self.norm2(x), H, W, kernel=sw.mhca_ffn))


class MHCAEncoder(nn.Module):
    """Stack of MHCABlocks sharing one CPE and one CRPE (MSTr.py:949-993),
    layer i at drop-path rate drop_path_rates[i] (all 0 if empty). Input
    and output are (B, H, W, C) maps; `gen` feeds the drop-path masks in
    training."""

    def __init__(self, dim: int, num_layers: int = 1, num_heads: int = 8,
                 mlp_ratio: int = 3, crpe_window=((3, 2), (5, 3), (7, 3)),
                 dtype=torch.bfloat16, folds: Folds = DEFAULT_FOLDS,
                 drop_path_rates=()):
        super().__init__()
        self.cpe = ConvPosEnc(dim, 3, dtype=dtype)
        self.crpe = ConvRelPosEnc(dim // num_heads, num_heads, crpe_window,
                                  dtype=dtype)
        rates = tuple(drop_path_rates) or (0.0,) * num_layers
        self.MHCA_layers = nn.ModuleList(
            MHCABlock(dim, num_heads, mlp_ratio, dtype, folds, rates[i])
            for i in range(num_layers))

    def forward(self, x, gen: Optional[torch.Generator] = None):
        B, H, W, C = x.shape
        t = x.reshape(B, H * W, C)
        for layer in self.MHCA_layers:
            t = layer(t, H, W, self.cpe, self.crpe, gen)
        return t.reshape(B, H, W, C)
