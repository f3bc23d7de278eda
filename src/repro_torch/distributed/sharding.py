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

Rules key on the nearest named ancestor of the leaf.  The port's layers
are a ModuleList, so no leaf carries a scan group axis and no spec has the
JAX package's leading None for one.  Left out, since nothing in the port
calls them: the deprecated shims ``param_specs`` / ``zero1_specs`` /
``batch_spec`` (``distributed.plan`` replaces them), the ``shard_map``
helper (the port has explicit per-rank shards), and ZeRO-1's moment specs
(``ShardingPlan.zero1`` waits for the training half, ROADMAP queue 1,
item 2).
"""

from __future__ import annotations

__all__ = ["MODEL_AXIS", "COL_PARALLEL", "ROW_PARALLEL", "EXPERT", "VOCAB", "INNER_VEC",
           "REPLICATED", "names_of", "leaf_spec"]

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
    """The spec of the leaf ``name`` with ``ndim`` dims (``_leaf_spec``)."""
    names = names_of(name)

    def spec(parts: tuple) -> tuple:
        return tuple(parts[:ndim])

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
        return () if ndim <= 1 else spec((None, MODEL_AXIS))
    if hit in ROW_PARALLEL:
        return () if ndim <= 1 else spec((MODEL_AXIS, None))
    if hit in EXPERT:
        return spec((MODEL_AXIS, None, None))
    if hit in INNER_VEC:
        return spec((MODEL_AXIS,) + (None,) * 3)
    if hit == "mamba" and leaf_name == "conv":
        return spec((None, MODEL_AXIS))
    if hit == "mamba" and leaf_name == "scale":   # mamba's gated norm over d_inner
        return spec((MODEL_AXIS,))
    return spec((None,) * 4)
