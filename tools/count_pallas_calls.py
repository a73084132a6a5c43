"""Count the Pallas kernels that the JAX package's programs reach, by
tracing them (jax.make_jaxpr, nothing compiled) on the CPU with
jax.default_backend patched to "tpu", so that the kernel gates decide as on
a TPU. Prints one JSON object: pallas_call counts by kernel name for the
eval forward (b=32: the fused argmax where the model has one, else the
argmax of its logits) and the train step (b=24, the wide head where the
model has one) of the published TransceptionConfig at fp32 (the published
eval protocol's dtype), per train mode; with --model, of that registry
model itself (the MSTransception variants and the legacy models:
models/registry.py), at --dtype; with --forward_only, only the eval
forward; with a TransceptionConfig field=value (--set concat=se), that
config.

    JAX_PLATFORMS=cpu python tools/count_pallas_calls.py
    JAX_PLATFORMS=cpu python tools/count_pallas_calls.py \
        --model mstransception_sp --dtype bfloat16
"""

import argparse
import dataclasses
import inspect
import json
import sys
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp

jax.default_backend = lambda: "tpu"  # the kernels' gates ask this
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repo

from transception_tpu.core.config import (  # noqa: E402
    TrainConfig,
    TransceptionConfig,
)
from transception_tpu.models.registry import MODEL_REGISTRY  # noqa: E402
from transception_tpu.train.state import create_train_state  # noqa: E402
from transception_tpu.train.trainer import (  # noqa: E402
    make_train_step,
    train_step_model,
)

MODES = {"default": {}, "ffn_flash_train": dict(ffn_flash_train=True),
         "use_pallas_train": dict(use_pallas_train=True)}


def pallas_calls(jaxpr, out=None):
    """pallas_call equations by kernel body (file:line and function),
    through every sub-jaxpr."""
    out = Counter() if out is None else out
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            # The kernel body: "<function> at <path>:<line>" -> file:line.
            src = eqn.params["jaxpr"].debug_info.func_src_info
            fn, _, where = src.partition(" at ")
            out[f"{Path(where).name} {fn}"] += 1
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else (v,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    pallas_calls(inner, out)
    return out


def takes(model, kwarg):
    """Whether the flax model's __call__ takes keyword `kwarg` (argmax,
    wide_head: MSTransception's, not the legacy models')."""
    return kwarg in inspect.signature(type(model).__call__).parameters


def forward_counts(model, batch=32):
    x = jax.ShapeDtypeStruct((batch, 224, 224, 1), jnp.float32)
    variables = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros(x.shape, x.dtype), train=False),
        jax.random.PRNGKey(0))

    def ids(v, im):  # as eval/inference.py's predictors take them
        if takes(model, "argmax"):
            return model.apply(v, im, argmax=True)
        return jnp.argmax(model.apply(v, im), axis=-1).astype(jnp.uint8)

    return pallas_calls(jax.make_jaxpr(ids)(variables, x).jaxpr)


def train_counts(model, batch=24):
    model = train_step_model(model)
    x = jnp.zeros((batch, 224, 224, 1), jnp.float32)
    y = jax.ShapeDtypeStruct((batch, 224, 224), jnp.int32)
    state = jax.eval_shape(lambda k: create_train_state(
        model, TrainConfig(batch_size=batch), 92, x, k),
        jax.random.PRNGKey(0))
    step = make_train_step(model, 9, 0.4, 0.6,
                           wide_head=takes(model, "wide_head"))
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    jaxpr = jax.make_jaxpr(step)(
        state, jax.ShapeDtypeStruct(x.shape, x.dtype), y, key)
    return pallas_calls(jaxpr.jaxpr)


def _value(text):
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="mstransception")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--forward_only", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="a TransceptionConfig field=value")
    args = ap.parse_args()
    over = dict(kv.split("=", 1) for kv in args.set)
    cfg = TransceptionConfig(dtype=args.dtype,
                             **{k: _value(v) for k, v in over.items()})
    build = MODEL_REGISTRY[args.model]
    res = {"model": args.model, "dtype": cfg.dtype, "set": over,
           "forward_b32": dict(forward_counts(build(cfg)))}
    for mode, over in ({} if args.forward_only else MODES).items():
        res[f"train_b24_{mode}"] = dict(
            train_counts(build(dataclasses.replace(cfg, **over))))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
