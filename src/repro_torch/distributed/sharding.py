"""Sharding rules: which axis of each parameter a mesh axis splits.

The JAX package's ``distributed/sharding.py`` rules over the port's
parameter names (``TernaryLM.state_dict()``'s, which ``models.model.
flatten_tree`` maps one to one onto the JAX package's tree paths).  A spec
is a plain tuple with one entry a dimension: an axis name or None.

  * TP — column-parallel projections shard their output dim on "model",
    row-parallel ones (wo / w_out) their input dim: the Megatron pair, one
    sum over "model" a block half.
  * EP — expert stacks shard the experts on "model".
  * Vocab — the embedding and the untied head shard the vocab on "model".
  * 1-D leaves along a model-sharded inner dim (``INNER_VEC``) shard it.

A TWD-packed slab is packed along K, so it inherits its master weight's
spec: an N shard never splits a byte.  A K shard of a packed slab is not a
slice of the slab (its rows are padded to 16 and a byte holds 5 lanes):
``models.shard`` repacks it from its trits.

Rules key on the nearest named ancestor of the leaf.  The serving
model's layers are a ModuleList, so its leaves carry no scan group axis; a
master tree's scan-stacked groups (``layers.stacked``) do, and their specs
get the JAX package's leading None for it.  ZeRO-1 (``zero1_specs``, which
``plan.ShardingPlan.zero1`` calls) shards an optimizer moment further along
the data axis: the first dim its param spec leaves unsharded whose size the
data extent divides, with one summary warning a tree for the leaves that
stay unsharded.  Left out, since nothing in the port calls them: the
deprecated shims ``param_specs`` / ``batch_spec`` (``distributed.plan``
replaces them) and the ``shard_map`` helper (the port has explicit per-rank
shards).
"""

from __future__ import annotations

import warnings

__all__ = ["MODEL_AXIS", "COL_PARALLEL", "ROW_PARALLEL", "EXPERT", "VOCAB", "INNER_VEC",
           "REPLICATED", "names_of", "leaf_spec", "zero1_specs"]

MODEL_AXIS = "model"

# nearest-ancestor name -> spec for the 2D master weight (in, out)
COL_PARALLEL = {"wq", "wk", "wv", "wg", "wz", "wx", "w_gate", "w_in", "ck",
                "shared_gate", "shared_in", "wa2", "w_decay2", "head"}
ROW_PARALLEL = {"wo", "w_out", "cv", "shared_out"}
EXPERT = {"experts_gate", "experts_in", "experts_out"}
VOCAB = {"embed"}
# 1-D leaves laid out along the model-sharded inner dim
INNER_VEC = {"w0", "ln_x"}
REPLICATED = {"router", "u", "wb", "wc", "wdt", "dt_bias", "a_log", "d_skip",
              "w_decay1", "wa1", "mix_t", "mix_c", "cr", "norm1", "norm2",
              "final_norm", "conv"}
_NAMED = COL_PARALLEL | ROW_PARALLEL | EXPERT | VOCAB | INNER_VEC | REPLICATED


def names_of(name: str) -> list[str]:
    """A dotted parameter name as the JAX package's path names: a list
    index (``layers.3``) becomes ``[3]``."""
    return [f"[{n}]" if n.isdigit() else n for n in name.split(".")]


def leaf_spec(name: str, ndim: int) -> tuple:
    """The spec of the leaf ``name`` with ``ndim`` dims (``_leaf_spec``);
    a leaf under ``stacked`` has a leading None for its group axis."""
    names = names_of(name)
    stacked = "stacked" in names
    core = ndim - (1 if stacked else 0)

    def spec(parts: tuple) -> tuple:
        parts = tuple(parts[:core])
        return ((None,) + parts) if stacked else parts

    leaf_name = names[-1] if names else ""
    hit = None
    for n in reversed([n for n in names if not n.startswith("[")]):
        if n in _NAMED or n == "mamba":
            hit = n
            break
    if leaf_name == "scale" and ndim <= 1 and hit not in INNER_VEC:
        return ()   # quantization / norm scalars and (d,) norm scales
    if hit in VOCAB:
        return spec((MODEL_AXIS, None))
    if hit in COL_PARALLEL:
        return () if core <= 1 else spec((None, MODEL_AXIS))
    if hit in ROW_PARALLEL:
        return () if core <= 1 else spec((MODEL_AXIS, None))
    if hit in EXPERT:
        return spec((MODEL_AXIS, None, None))
    if hit in INNER_VEC:
        return spec((MODEL_AXIS,) + (None,) * 3)
    if hit == "mamba" and leaf_name == "conv":
        return spec((None, MODEL_AXIS))
    if hit == "mamba" and leaf_name == "scale":   # mamba's gated norm over d_inner
        return spec((MODEL_AXIS,))
    return spec((None,) * 4)


def zero1_specs(specs: dict, leaves: dict, data_size: int, data_axis: str = "data") -> dict:
    """ZeRO-1 (``_zero1_specs``): each leaf's spec with ``data_axis`` put
    into the first dim it leaves unsharded whose size divides by
    ``data_size``.  A leaf with no such dim keeps its spec; one summary
    warning a tree counts those leaves and their bytes.  ``specs`` and
    ``leaves`` ({name: tensor}, shapes and dtypes read) share their names."""
    skipped = [0, 0]    # leaves, bytes

    def one(spec: tuple, x) -> tuple:
        shape = tuple(x.shape)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        for i, s in enumerate(parts):
            if s is None and shape[i] > 0 and shape[i] % data_size == 0:
                parts[i] = data_axis
                return tuple(parts)
        skipped[0] += 1
        skipped[1] += x.numel() * x.element_size()
        return spec

    out = {name: one(spec, leaves[name]) for name, spec in specs.items()}
    if skipped[0]:
        warnings.warn(
            f"zero1_specs: {skipped[0]} moment leaves "
            f"({skipped[1] / 2**20:.2f} MiB per moment) have no dim "
            f"divisible by {data_axis}={data_size} and stay unsharded "
            f"(replicated across the data axis)", stacklevel=3)
    return out
