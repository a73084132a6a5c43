"""Model, training and data configuration of the PyTorch port.

TransceptionConfig mirrors the model-defining fields of the JAX package's
TransceptionConfig (same names, same defaults: the published 82.24-DSC
MSTransception, networks/MSTr.py:2759-2823), its `ffn_flash_train`, its
`use_pallas_train` and its six per-op fold switches (bridge_attn_fold,
bridge_ffn_use_pallas, etb_attn_fold, etb_ffn_fold, mhca_ffn_fold,
mhca_block_fold), each picking for one family of blocks between one
folded kernel and the chain of separate modules; `fold_switches` resolves
them for eval or training; `remat` recomputes the MHCA stages in the
backward as the JAX field does; `bridge_seq_shard_axis` ("model")
shards the original bridge's query rows and per-scale FFN map rows over
the model axis of a tensor-parallel run (models.bridge.BridgeBlock4
seq_shard_), as the JAX field does; `vectorize_paths` names the JAX
package's MHCA weight layout, which decides what a tensor-parallel run
shards (parallel.mesh.shard_layout). The TPU-only knobs
(bridge_use_pallas, lane packing and the kernel fallback ladder) are not
carried over; `use_kernels` selects the hand-written CUDA kernels on the
card (and what a fold switch of None follows, as JAX's follow
use_pallas). TrainConfig mirrors the JAX TrainConfig field for
field; DataConfig the fields the train loop reads.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

# Convolutional relative position encoding window split, reference
# networks/MSTr.py:958 (crpe_window={3: 2, 5: 3, 7: 3}).
CRPE_WINDOW: Tuple[Tuple[int, int], ...] = ((3, 2), (5, 3), (7, 3))


def br_config_to_ch_att_list(br_config: int) -> Tuple[bool, bool, bool, bool]:
    """Bridge layer channel/spatial attention selection
    (train_MSTransception.py:145-159): True = channel attention."""
    table = {
        0: (False, False, False, False),
        1: (True, True, True, True),
        2: (True, False, False, False),
        3: (False, True, False, True),
    }
    return table.get(br_config, (True, False, True, False))


def use_sa_config_to_list(use_sa_config: int, concat: str, stage_3or4: int
                          ) -> Tuple[bool, ...]:
    """CBAM spatial-attention switches per stage (networks/MSTr.py:
    2766-2779): any concat but cbam, or the 4-stage backbone, forces
    (T, T, T, F)."""
    table = {
        1: (True, True, False),
        2: (True, False, False),
        3: (False, False, False),
        4: (True, True, True),
    }
    lst = table.get(use_sa_config, (True, True, True, False))
    if concat != "cbam" or stage_3or4 == 4:
        lst = (True, True, True, False)
    return lst


# The values of the ablation switches the model takes (JAX core/config.py
# 82-90, 240-241; train_MSTransception.py:18-95).
TOKEN_MLPS = ("mix", "mix_skip", "mlp")
CONCATS = ("normal", "3d", "se", "skn", "cbam", "coord", "cam", "cam_fact")
BRIDGES = ("original", "sp", "para", "none", "None")
SEQ_SHARD_AXES = ("", "model")


@dataclasses.dataclass(frozen=True)
class TransceptionConfig:
    """MSTransception architecture; defaults are the published model."""

    num_classes: int = 9
    img_size: int = 224
    in_chans: int = 3  # gray inputs are repeated to 3 channels
    dims: Tuple[int, int, int, int] = (64, 128, 320, 512)
    stage1_layers: int = 2
    num_path: Tuple[int, ...] = (3, 3, 3)
    num_layers: Tuple[int, ...] = (3, 8, 3)
    num_heads: Tuple[int, ...] = (8, 8, 8)
    mlp_ratio: int = 4
    token_mlp: str = "mix_skip"  # mix | mix_skip | mlp
    # IFF fusion of the MHCA stages: normal|3d|se|skn|cbam|coord|cam|cam_fact
    concat: str = "coord"
    have_bridge: str = "original"  # original | sp | para | none
    br_ch_att_list: Tuple[bool, bool, bool, bool] = (True, False, False, False)
    stage_3or4: int = 3  # 3 | 4 | anything else: the casa backbone
    use_sa_config: int = 1  # CBAM spatial gates per stage (use_sa_list)
    sa_ker: int = 7  # CBAM spatial gate's kernel size
    inter: str = "res"  # casa CBAM interface: res | out
    num_sp: int = 1  # SpatialAwareTrans layers of the 'sp' bridge
    # The legacy models' knobs (models/legacy.py): the heads of the
    # two-branch encoders' fused-sequence attention, and the dilated (1)
    # or plain (0) patch-embed schedules of the inception encoders.
    head_count: int = 8
    dil_conv: int = 1
    bridge_dim: int = 64
    bridge_heads: int = 1
    reduction_ratios: Tuple[int, int, int, int] = (1, 2, 4, 8)
    # Sequence parallelism of the original bridge (JAX core/config.py:
    # 97-99): "model" splits each bridge layer's attention query rows and
    # its per-scale FFN inputs (whole map rows, with their halo rows) over
    # the model axis of a run with tp_size > 1; "" (or tp 1) leaves the
    # bridge whole. The stream stays replicated at every layer's edges,
    # and no weight changes layout. No CLI flag sets it (neither JAX CLI
    # builds it): a Trainer's config does.
    bridge_seq_shard_axis: str = ""
    # The JAX package's MHCA parameter layout (JAX core/config.py:193):
    # True stacks each MHCA stage's per-path encoders into one vmapped
    # encoder (3-D kernels, which the TP rules leave replicated); False
    # keeps one encoder per path (2-D kernels: under --tp_size each MHCA
    # block's qkv and FFN shard). The port runs one module per path either
    # way, so at tp 1 the model and its results are the same.
    vectorize_paths: bool = True
    # Compute dtype of matmuls/convs; params and norm/softmax statistics
    # stay fp32.
    dtype: str = "bfloat16"
    drop_rate: float = 0.1
    # Stochastic depth of the MHCA blocks, decayed linearly over the
    # stages' layers (models.msvit.dpr_schedule); 0 in the reference.
    drop_path_rate: float = 0.0
    # Kernels in the TRAINING step (JAX core/config.py:107-113): False
    # runs the train step's kernel set (the bridge attention, plus the
    # MixFFN folds with ffn_flash_train); True keeps every kernel and fold
    # switch as in eval (JAX train_step_model returns the model as it
    # is), the forward kernels without a backward kernel differentiated
    # through their plain versions. A block with a drop-path rate above 0
    # runs unfolded in training, so that stochastic depth stays exact.
    use_pallas_train: bool = False
    # Recompute each MHCA stage of the 3-stage backbone in the backward
    # instead of keeping its activations (torch.utils.checkpoint, where the
    # JAX MSViT applies nn.remat, msvit.py:198-199; not in the casa or
    # 4-stage backbones): less memory a train step, the same step.
    remat: bool = False
    # Keep the fused MixFFN_skip kernels on in the train step (ETB, MHCA
    # and bridge per-scale FFNs, K2 forward + K11 backward), as the JAX
    # field of this name; off, the train step runs only the bridge
    # attention kernels (ops.kernels.kernel_set).
    ffn_flash_train: bool = False
    # Per-op fold switches (JAX core/config.py:129-179, same defaults; None
    # follows use_kernels). Each picks the structure a family of blocks
    # runs in eval, whatever the device (fold_switches):
    #   bridge_attn_fold: the bridge spatial attention with its q/out
    #     projections and the residual as one kernel (K8), else q Dense ->
    #     K3 -> proj -> + residual;
    #   bridge_ffn_use_pallas: the bridge's norm2 (as a grouped LN) and
    #     residual folded into its per-scale FFNs (K2 at scales 1-3);
    #   etb_attn_fold / etb_ffn_fold: each EfficientTransformerBlock's
    #     attention sub-block as K1, else norm1 -> EfficientAttention (K6
    #     with the softmax of Q) -> + x; its FFN sub-block as K2, else
    #     norm2 -> MixFFN_skip -> + x;
    #   mhca_block_fold: each MHCA block on an even-sided map as K5;
    #   mhca_ffn_fold: else its FFN sub-block as K2 (even-sided maps).
    bridge_attn_fold: Optional[bool] = False
    bridge_ffn_use_pallas: Optional[bool] = False
    etb_attn_fold: Optional[bool] = None
    etb_ffn_fold: Optional[bool] = None
    mhca_ffn_fold: Optional[bool] = False
    mhca_block_fold: Optional[bool] = True
    # The sp and para bridges' folds: their spatial attention as K8 and
    # their per-scale FFNs as K2 (norm2 as a grouped LN), both by the
    # bridge's kernel switch, JAX's bridge_use_pallas (those bridges take
    # no attn_fold or ffn_use_pallas, JAX models/transception.py:63-73).
    # None follows use_kernels in eval and is on in training, where the
    # JAX train step sets bridge_use_pallas (train/trainer.py:104).
    sp_bridge_fold: Optional[bool] = None
    # Run the hand-written CUDA kernels (ops/kernels) on CUDA tensors.
    # False runs their plain PyTorch versions instead (comparison only).
    use_kernels: bool = True

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def use_sa_list(self) -> Tuple[bool, ...]:
        return use_sa_config_to_list(self.use_sa_config, self.concat,
                                     self.stage_3or4)

    @property
    def stage1_res(self) -> int:
        return self.img_size // 4

    def bridge_token_splits(self) -> Tuple[int, ...]:
        """Token counts of each scale in the fused bridge sequence, in
        bridge_dim-channel tokens (3136/1568/980/392 at 224)."""
        c_mults = tuple(d // self.bridge_dim for d in self.dims)
        sides = tuple(self.stage1_res // (1 << i) for i in range(4))
        return tuple(s * s * m for s, m in zip(sides, c_mults))

    def decoder_in_chans(self) -> Tuple[int, int, int, int]:
        """Per-stage decoder 'dims' (in_out_chan[0], MSTr.py:2814-2823):
        (512, 288, 144, 32) at the defaults."""
        d = self.dims
        return (d[3],
                (d[3] // 2 + d[2]) // 2,
                (d[2] // 2 + d[1]) // 2,
                (d[1] // 2 + d[0]) // 4)

    def validate(self) -> "TransceptionConfig":
        if self.img_size % 32:
            raise ValueError("img_size must be divisible by 32")
        if self.token_mlp not in TOKEN_MLPS:
            raise ValueError(f"token_mlp must be one of {TOKEN_MLPS}")
        if self.concat not in CONCATS:
            raise ValueError(f"concat must be one of {CONCATS}")
        if self.have_bridge not in BRIDGES:
            raise ValueError(f"have_bridge must be one of {BRIDGES}")
        if self.bridge_seq_shard_axis not in SEQ_SHARD_AXES:
            raise ValueError(
                f"bridge_seq_shard_axis must be one of {SEQ_SHARD_AXES} "
                f"(the model axis, or none), got "
                f"{self.bridge_seq_shard_axis!r}")
        if not len(self.num_path) == len(self.num_layers) == len(
                self.num_heads) == 3:
            raise ValueError("num_path/num_layers/num_heads need 3 entries")
        for d in self.dims[1:]:
            if d % self.bridge_dim:
                raise ValueError("bridge requires dims that are multiples "
                                 "of bridge_dim")
        return self


class FoldSwitches(NamedTuple):
    """The resolved fold switches: which structure each family of blocks
    runs (True: the folded kernel's structure)."""

    bridge_attn: bool
    bridge_ffn: bool
    etb_attn: bool
    etb_ffn: bool
    mhca_block: bool
    mhca_ffn: bool
    sp_bridge: bool  # the sp and para bridges' attention and FFN folds


def fold_switches(cfg: TransceptionConfig, training: bool) -> FoldSwitches:
    """The fold switches a model with config `cfg` runs. In eval a switch
    of None follows use_kernels (JAX: use_pallas). In training they resolve
    as JAX train_step_model does (train/trainer.py:90-119): with
    use_pallas_train as in eval, a switch of None following
    use_pallas_train; else the bridge attention and the MHCA block
    unfolded, the ETB attention unfolded, the three FFN folds on only with
    ffn_flash_train; the sp and para bridges' folds (sp_bridge_fold) on in
    training in every mode, as JAX's bridge_use_pallas. The train
    resolution does not depend on use_kernels,
    so the plain path (use_kernels=False) runs the kernel path's structure.
    (The MHCA blocks with a drop-path rate above 0 unfold in training
    whatever their switches say, ops.attention.MHCABlock.) A function of
    the config alone, never of the device."""
    sp = (training or cfg.use_kernels) if cfg.sp_bridge_fold is None \
        else bool(cfg.sp_bridge_fold)
    if training and not cfg.use_pallas_train:
        f = cfg.ffn_flash_train
        return FoldSwitches(bridge_attn=False, bridge_ffn=f, etb_attn=False,
                            etb_ffn=f, mhca_block=False, mhca_ffn=f,
                            sp_bridge=sp)
    follow = cfg.use_pallas_train if training else cfg.use_kernels

    def pick(v):
        return follow if v is None else bool(v)

    return FoldSwitches(
        bridge_attn=pick(cfg.bridge_attn_fold),
        bridge_ffn=pick(cfg.bridge_ffn_use_pallas),
        etb_attn=pick(cfg.etb_attn_fold), etb_ffn=pick(cfg.etb_ffn_fold),
        mhca_block=pick(cfg.mhca_block_fold),
        mhca_ffn=pick(cfg.mhca_ffn_fold), sp_bridge=sp)


Folds = Tuple[FoldSwitches, FoldSwitches]


def fold_table(cfg: TransceptionConfig) -> Folds:
    """fold_switches of `cfg` indexed by `training` (False, True): what a
    model passes down to its blocks, which pick by their .training."""
    return fold_switches(cfg, False), fold_switches(cfg, True)


# The default config's: a block's default when built on its own.
DEFAULT_FOLDS: Folds = fold_table(TransceptionConfig())


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The JAX DataConfig (core/config.py:250-267), field for field: the
    train slices (root_path, list_dir, augment) through the host loader's
    num_workers threads (data.synapse.make_train_dataset,
    data.loader.HostDataLoader), or with device_data the synthetic batches
    made on the device (synthetic only); the test volumes read test_path
    and list_dir (data.synapse.make_test_dataset)."""

    dataset: str = "synapse"  # synapse | isic | synthetic
    root_path: str = "./data/Synapse/train_npz"
    test_path: str = "./data/Synapse/test_vol_h5"
    list_dir: str = "./lists/lists_Synapse"
    img_size: int = 224
    num_classes: int = 9
    num_workers: int = 4
    augment: bool = True
    # Length of the synthetic train set (lists_Synapse/train.txt).
    synthetic_len: int = 2211
    # Synthetic train batches made on the device (DeviceSyntheticStream)
    # instead of streamed from the host; synthetic only.
    device_data: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training recipe (JAX core/config.py:271-317, the reference's
    trainer.py:123-157), field for field."""

    base_lr: float = 0.05
    batch_size: int = 24  # global batch (train_MSTransception.py:35)
    max_epochs: int = 400
    momentum: float = 0.9
    weight_decay: float = 1e-4
    use_scheduler: bool = True  # cosine per iteration, else poly 0.9
    grad_clipping: bool = False  # clip_grad_norm max 5
    grad_accum_steps: int = 1
    ce_weight: float = 0.4
    dice_weight: float = 0.6
    seed: int = 1234
    eval_interval: int = 20
    eval_schedule: str = "interval"
    output_dir: str = "./output"
    model_name: str = "transception_tpu"
    dp_size: int = -1
    tp_size: int = 1
    # Checkpoint every N epochs (and at the end); resume from the newest.
    ckpt_every: int = 20
    resume: bool = True
    eval_device_resample: bool = False
    # Loss in pre-pixel-shuffle token order (MSTransception wide_head).
    wide_loss: bool = True

    def scaled_lr(self) -> float:
        """LR linear scaling rule (train_MSTransception.py:123-124)."""
        if self.batch_size != 24 and self.batch_size % 5 == 0:
            return self.base_lr * self.batch_size / 24
        return self.base_lr
