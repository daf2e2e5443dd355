"""svpc_torch's partition rules (parallel/mesh.py) against svpc_tpu's,
leaf by leaf through the ``from_jax`` name mapping, at the paper config
(vivt, hidden 768, 12 heads, the 951-word vocabulary padded to 952 for
tp=2), on abstract shapes (``jax.eval_shape``): no collective runs."""

import functools
import math

import pytest
import torch

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _paper_leaves():
    """[(flax key, shape, svpc_tpu path)] of svpc_tpu's paper-config
    parameters (vocab_pad_multiple=2)."""
    import jax
    from svpc_tpu.config import Config, ModelConfig
    from svpc_tpu.data.synthetic import synthetic_batch
    from svpc_tpu.model import SVPCModel

    cfg = Config(model=ModelConfig(model_mode="full", vocab_pad_multiple=2))
    batch = synthetic_batch(cfg, batch_size=1, seed=0)
    rngs = {k: jax.random.PRNGKey(i)
            for i, k in enumerate(("params", "dropout", "gumbel"))}
    abstract = jax.eval_shape(lambda: SVPCModel(cfg.model).init(
        rngs, batch, deterministic=True))
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            abstract["params"])[0]:
        key = "/".join(p.key for p in path)
        out.append((key, tuple(leaf.shape), path))
    return out


def _dims(spec, axis):
    return [d for d, ax in enumerate(spec) if ax == axis
            or (isinstance(ax, tuple) and axis in ax)]


def _held(spec, shape, axes) -> int:
    """Elements of a leaf one rank holds under ``spec``."""
    parts = math.prod(axes[a] for ax in spec if ax is not None
                      for a in (ax if isinstance(ax, tuple) else (ax,)))
    return math.prod(shape) // parts


@pytest.mark.parametrize("axes", [{"dp": 1, "tp": 2}, {"dp": 2, "tp": 1},
                                  {"dp": 4, "tp": 2}],
                         ids=["tp2", "dp2", "dp4xtp2"])
def test_rules_shard_the_same_leaves_as_svpc_tpu(axes):
    """Every parameter is tp-split on the same logical axis (dim d of a
    flax kernel is dim 1 - d of the torch weight) and ZeRO-1 slices the
    same leaves over dp, to the same bytes a rank; the tp rule fires on
    every targeted leaf (no fallback at the paper geometry); the flagship
    has 40,144,393 parameters in 173 tensors, and at dp2 only five
    leaves stay whole."""
    from jax.sharding import PartitionSpec as P
    from svpc_tpu.parallel.mesh import _resolve_spec as jax_resolve
    from svpc_tpu.parallel.mesh import param_partition_spec as jax_rule
    from svpc_tpu.parallel.mesh import zero1_partition_spec as jax_zero1
    from svpc_torch.model.from_jax import build_mapping
    from svpc_torch.parallel.mesh import (_resolve_spec,
                                          param_partition_spec,
                                          zero1_partition_spec)

    mapping = build_mapping("full", 2)
    leaves = _paper_leaves()
    assert len(leaves) == len(mapping) == 173
    assert sum(math.prod(s) for _, s, _ in leaves) == 40_144_393
    whole = []
    for key, shape, path in leaves:
        name, tr = mapping[key]
        tshape = shape[::-1] if tr == "T" else shape
        flip = (lambda d: len(shape) - 1 - d) if tr == "T" else (lambda d: d)
        jspec = jax_resolve(jax_rule(path), shape, axes)
        pspec = _resolve_spec(param_partition_spec(name), tshape, axes)
        assert sorted(flip(d) for d in _dims(jspec, "tp")) == \
            _dims(pspec, "tp"), (key, jspec, pspec)
        if any(ax is not None for ax in jax_rule(path)) and axes["tp"] > 1:
            assert jspec != P(), f"{key}: the tp rule fell back"
        jz = jax_zero1(path, shape, axes)
        pz = zero1_partition_spec(name, tshape, axes)
        assert bool(_dims(jz, "dp")) == bool(_dims(pz, "dp")), (key, jz, pz)
        assert _held(jz, shape, axes) == _held(pz, tshape, axes), key
        if not _dims(pz, "dp"):
            whole.append(name)
    if axes == {"dp": 2, "tp": 1}:
        assert sorted(whole) == sorted([
            "reasoner.W3.bias", "reasoner.W4.bias", "pgen_linear.0.bias",
            "recipe_reasoner.W3.bias", "recipe_reasoner.W4.bias"])


def test_shard_report_fallback_and_padded_tables():
    """At the paper config on tp=2 every vocabulary table has 952 rows and
    each rank holds 476 of them (its own), the attention holds 6 of the 12
    heads, and the report names every targeted tensor with its spec; at
    an odd, unpadded vocabulary (951) the vocabulary rules fall back to
    replication, and the report says so."""
    from svpc_torch.config import ModelConfig
    from svpc_torch.model import SVPCModel
    from svpc_torch.parallel.mesh import Mesh, shard_params

    cfg = ModelConfig(model_mode="full", vocab_pad_multiple=2)
    model = SVPCModel(cfg, torch.Generator().manual_seed(0))
    full = {n: t.clone() for n, t in model.state_dict().items()}
    mesh = Mesh(dp_size=1, tp_size=2, dp_index=0, tp_index=1)
    report = {}
    model.shard(mesh, report)
    local = model.state_dict()
    for name in ("text_embeddings.word_embeddings.weight",
                 "ingredient_embeddings.word_embeddings.weight"):
        assert full[name].shape == (952, 300)
        assert torch.equal(local[name], full[name][476:])
        assert report[name] == "('tp', None)"
    assert torch.equal(local["decoder_classifier.decoder.weight"],
                       full["decoder_classifier.decoder.weight"][476:])
    assert torch.equal(local["encoder.layer.0.output.dense.weight"],
                       full["encoder.layer.0.output.dense.weight"][:, 384:])
    assert model.encoder.layer[0].attention.self.num_heads == 6
    assert not any(v.startswith("replicated") for v in report.values())
    # a split tensor holds half its elements, the rest are whole (28.16M)
    assert sum(p.numel() for p in model.parameters()) == sum(
        t.numel() // (2 if n in report and "tp" in report[n] else 1)
        for n, t in full.items())

    odd = ModelConfig(model_mode="full", vocab_size=951)
    report = {}
    shard_params(SVPCModel(odd).state_dict(), mesh, report)
    assert report["text_embeddings.word_embeddings.weight"] == \
        "replicated(951, 300)"
    assert report["decoder_classifier.bias"] == "replicated(951,)"
    assert report["encoder.layer.0.attention.self.query.weight"] == \
        "('tp', None)"
