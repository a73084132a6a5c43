"""Load JAX-package variables into the PyTorch port.

The port's state_dict keys are the reference torch keys, derived from the
flax parameter paths by the same translation as the JAX package's
convert/torch2flax.py:68 `flax_path_to_torch_key` (a copy: the 'ln'/'bn'
wrapper levels drop, list modules `name_i` become `name.i` or their
renamed torch ModuleList, `inv_res` becomes `InvRes`, the fusion blocks'
and the para/sp bridges' modules their reference names, flax leaf names
torch ones), with its fallback keys for the fusion blocks' Sequentials.
The legacy models' trees (models/legacy.py) pass the same translation:
their stages' blocks block{s}_{i} become the ModuleLists block{s}.{i};
patch_embed2_1, resInception2_2 and layer_former_1 (no list names) keep
their flax names, as do conv1_1_s2 and sk_concat2 (whose SK Sequential
takes the fallback keys), and the MultiRes branches' conv, bn (with its
statistics) and norm leaves. `load_jax_variables`
applies the inverse layout transforms and fills the port in place, strictly.
`train_state_from_jax` converts a whole JAX Trainer checkpoint (the raw
pytree of transception_tpu/train/trainer.py:223-233 save_checkpoint) into
the port's TrainState.state_dict(): model, SGD momentum buffers and
counters; scripts/orbax_to_torch.py reads the orbax directory for it.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from transception_tpu_torch.core.device import DeviceLike, resolve_device

# Copies of the tables of transception_tpu/convert/torch2flax.py:24-65.
_LIST_RENAMES = {
    "block1": "block1",
    "block2": "block2",  # the legacy encoders' stages 2-4
    "block3": "block3",
    "block4": "block4",
    "mhca_blks": "mhca_blks",
    "layers": "MHCA_layers",
    "patch_embeds": "patch_embeds",
    "conv": "conv_list",  # ConvRelPosEnc conv_{j}
    "stem": "stem",  # the 4-stage backbone's Conv2d_BN stem
    "group_attention": "group_attention",  # SpatialAwareTrans blocks
    "fc_back": "fc_back",
    "fcs": "fcs",  # SK's per-path fcs
}
_PLAIN_RENAMES = {"inv_res": "InvRes",
                  "channel_attention": "channelAttention"}
_LIST_RE = re.compile(r"^([a-zA-Z_0-9]*?)_(\d+)$")
_LEAF_RENAMES = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
    "gamma": "gamma",
}
# (parent module, flax name) -> torch name: the fusion blocks' Sequentials.
_CONTEXT_RENAMES = {
    ("se", "fc1"): "excitation.0",
    ("se", "fc2"): "excitation.2",
    ("ca", "se_fc1"): "se.0",
    ("ca", "se_fc2"): "se.2",
}


def flax_path_to_torch_key(path: str) -> str:
    """'backbone/block1_0/attn/keys/kernel' -> 'backbone.block1.0.attn.keys.weight'."""
    elems = path.split("/")
    leaf, body = elems[-1], elems[:-1]
    if body and body[-1] in ("ln", "bn"):
        body = body[:-1]
    out: List[str] = []
    for i, e in enumerate(body):
        m = _LIST_RE.match(e)
        parent = body[i - 1] if i > 0 else ""
        if m and m.group(1) in _LIST_RENAMES:
            out += [_LIST_RENAMES[m.group(1)], m.group(2)]
        elif e in _PLAIN_RENAMES:
            out.append(_PLAIN_RENAMES[e])
        elif (parent, e) in _CONTEXT_RENAMES:
            out.append(_CONTEXT_RENAMES[(parent, e)])
        else:
            out.append({"se_fc1": "se.0", "se_fc2": "se.2"}.get(e, e))
    key = ".".join(out)
    key = key.replace("aggregate.fc1", "aggregate.excitation.0")
    key = key.replace("aggregate.fc2", "aggregate.excitation.2")
    full = f"{key}.{_LEAF_RENAMES.get(leaf, leaf)}"
    # The para bridge's proj_act (Linear, LN, GELU; MSTr.py:2506-2510) and
    # the sp bridge's SpatialAwareTrans inside bridge_layer1 (:2682).
    full = full.replace("bridge.proj.", "bridge.proj_act.0.")
    full = full.replace("bridge.proj_norm.", "bridge.proj_act.1.")
    return full.replace("bridge.bridge_layer1_sp.",
                        "bridge.bridge_layer1.scale_fuse_att.")


def _candidate_keys(key: str) -> List[str]:
    """key, then the fusion blocks' Sequential placements of conv and bn
    (CBAM's conv2d_bn_act.0/1, SK's conv_bn_ac.0/2), as
    torch2flax.py:122-139 tries them; SK's also under the legacy
    two-branch encoder's sk_concat{s} (models/legacy.py MiT3Inception)."""
    sk = r"(aggregate|sk_concat\d)"
    cands = [key,
             re.sub(r"aggregate\.conv\.weight$",
                    "aggregate.conv2d_bn_act.0.weight", key),
             re.sub(r"aggregate\.bn\.", "aggregate.conv2d_bn_act.1.", key),
             re.sub(sk + r"\.conv\.(weight|bias)$", r"\1.conv_bn_ac.0.\2",
                    key),
             re.sub(sk + r"\.bn\.", r"\1.conv_bn_ac.2.", key)]
    return list(dict.fromkeys(cands))


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):
            yield from _leaves(v, p)
        else:
            yield p, np.asarray(v, dtype=np.float32)


def _jax_entries(variables) -> Iterator[Tuple[str, str, np.ndarray]]:
    """(flax path, torch key, array) for every leaf; path-stacked MHCA
    encoders (vectorize_paths) unstack into mhca_blks.{i}."""
    for coll in ("params", "batch_stats"):
        for path, arr in _leaves(variables.get(coll, {})):
            if "mhca_blks_stacked" in path:
                for i in range(arr.shape[0]):
                    sub = path.replace("mhca_blks_stacked", f"mhca_blks_{i}")
                    yield path, flax_path_to_torch_key(sub), arr[i]
            else:
                yield path, flax_path_to_torch_key(path), arr


def _to_torch_layout(arr: np.ndarray, want: Tuple[int, ...]) -> np.ndarray:
    """flax HWIO conv kernel -> OIHW (depthwise (kh, kw, 1, C) -> (C, 1,
    kh, kw)); Dense (in, out) -> Linear (out, in); the Conv3d kernel (O,
    C·P) -> (O, C, P, 1, 1); vectors unchanged."""
    if arr.ndim == 2 and len(want) == 5:
        arr = arr.reshape(want)
    elif arr.ndim == 4 and len(want) == 4:
        arr = arr.transpose(3, 2, 0, 1)
    elif arr.ndim == 2 and len(want) == 2:
        arr = arr.T
    return np.array(arr, dtype=np.float32, order="C", copy=True)


def _port_arrays(targets: Dict[str, torch.Tensor], variables: Dict,
                 what: str) -> Dict[str, np.ndarray]:
    """{port key: array in the port's layout} for every leaf of a JAX
    {'params', 'batch_stats'} tree, strictly against `targets` (port key ->
    tensor): raises if any JAX leaf has no port tensor, any target is left
    unfilled, or a shape disagrees."""
    out, unused, bad = {}, [], []
    for path, key, arr in _jax_entries(variables):
        key = next((k for k in _candidate_keys(key) if k in targets), key)
        t = targets.get(key)
        if t is None:
            unused.append(f"{path} -> {key}")
            continue
        a = _to_torch_layout(arr, tuple(t.shape))
        if a.shape != tuple(t.shape):
            bad.append(f"{path} -> {key}: {a.shape} vs {tuple(t.shape)}")
            continue
        out[key] = a
    unfilled = sorted(set(targets) - set(out))
    if unused or unfilled or bad:
        raise KeyError(
            f"{what}: "
            f"{len(unused)} unused JAX leaves {unused[:20]}; "
            f"{len(unfilled)} unfilled port tensors {unfilled[:20]}; "
            f"{len(bad)} shape mismatches {bad[:20]}")
    return out


def load_jax_variables(model: torch.nn.Module, variables: Dict,
                       device: DeviceLike = "cuda") -> torch.nn.Module:
    """Move `model` to `device` and fill it in place from a JAX
    {'params', 'batch_stats'} tree of nested dicts of arrays. Raises if any
    JAX leaf has no port tensor, any port tensor is left unfilled, or a
    shape disagrees."""
    model.to(resolve_device(device))
    targets = model.state_dict()
    arrays = _port_arrays(targets, variables, "load_jax_variables")
    with torch.no_grad():
        for key, a in arrays.items():
            targets[key].copy_(torch.from_numpy(a))
    return model


def train_state_from_jax(tree: Dict, model: torch.nn.Module, train_cfg,
                         steps_per_epoch: int) -> dict:
    """A port TrainState.state_dict() (train/state.py) from the raw pytree
    of a JAX Trainer checkpoint, {'params', 'batch_stats', 'opt_state',
    'step'} (transception_tpu/train/trainer.py:223-233), numpy only.

    `model` (on the CPU, of the run's config) is filled from params and
    batch_stats (load_jax_variables). The optimizer is the recipe's chain
    (transception_tpu/train/state.py:56-64): clip_by_global_norm when
    train_cfg.grad_clipping, add_decayed_weights, trace, then
    scale_by_learning_rate, inside optax MultiSteps when
    grad_accum_steps > 1. trace's leaves are torch SGD's momentum buffers
    (both keep buf = g + wd·p + 0.9·buf), moved into the port's layout as
    the params are; `updates` is the schedule's count, `step` the JAX
    step. A checkpoint taken inside an accumulation window (MultiSteps
    mini_step != 0) raises: the port keeps no partial gradient sums. A
    chain that does not match train_cfg raises."""
    from transception_tpu_torch.train.state import TrainState
    k = train_cfg.grad_accum_steps
    opt = tree["opt_state"]
    multi = isinstance(opt, dict) and "inner_opt_state" in opt
    if multi != (k > 1):
        does = "accumulates" if multi else "does not accumulate"
        raise ValueError(f"the checkpoint {does} gradients (optax "
                         f"MultiSteps) but grad_accum_steps is {k}")
    if multi:
        mini = int(np.asarray(opt["mini_step"]))
        if mini:
            raise ValueError(
                f"the checkpoint was taken {mini} micro-steps into an "
                f"accumulation window of {k}: the port keeps no partial "
                f"gradient sums, so only a checkpoint at a window boundary "
                f"(mini_step 0) converts")
        opt = opt["inner_opt_state"]
    chain = list(opt)  # orbax restores the chain's tuple as a list
    want = 3 + bool(train_cfg.grad_clipping)
    if len(chain) != want or not isinstance(chain[-2], dict) \
            or "trace" not in chain[-2] or "count" not in chain[-1]:
        raise ValueError(
            f"the checkpoint's optimizer chain has {len(chain)} transforms; "
            f"the recipe of grad_clipping={train_cfg.grad_clipping} has "
            f"{want} (clip, decay, trace, lr)")
    load_jax_variables(model, {"params": tree["params"],
                               "batch_stats": tree.get("batch_stats", {})},
                       device="cpu")
    params = dict(model.named_parameters())
    bufs = _port_arrays(params, {"params": chain[-2]["trace"]},
                        "train_state_from_jax (momentum)")
    state = TrainState(model, train_cfg, steps_per_epoch)
    for name, p in params.items():
        state.optimizer.state[p]["momentum_buffer"] = \
            torch.from_numpy(bufs[name])
    state.step = int(np.asarray(tree["step"]))
    state.updates = int(np.asarray(chain[-1]["count"]))
    return state.state_dict()
