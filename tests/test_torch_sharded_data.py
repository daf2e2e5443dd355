"""The trainer's per-rank data on a dp mesh: ``pack_examples(only_shards=
...)`` against svpc_tpu's, and each rank's block (``parallel.mesh.
shard_batch``) against its slice of the global build and against the
packing of its own videos alone."""

import numpy as np
import pytest

B, DP = 8, 4


def _examples(seed=13):
    """The same 8 videos as svpc_tpu's and as the port's Examples."""
    from svpc_tpu.config import tiny_test_config
    from svpc_tpu.data.pipeline import Example as JaxExample
    from svpc_tpu.data.synthetic import synthetic_batch
    from svpc_torch.data.pipeline import Example

    cfg = tiny_test_config("full")
    bn = synthetic_batch(cfg, B, seed=seed)
    rows = [{k: v[i] for k, v in bn.items()} for i in range(B)]
    return (cfg, [JaxExample(arrays=r, meta={}) for r in rows],
            [Example(arrays=r, meta={}) for r in rows])


def test_only_shards_blocks_equal_svpc_tpu():
    """For each shard set (one shard, two, none) the port's restricted
    build is byte-equal to svpc_tpu's, every key; the owned blocks equal
    the full build's and the others stay fill-valued."""
    from svpc_tpu.data.packing import pack_examples as jax_pack
    from svpc_torch.data.packing import pack_examples

    cfg, jex, ex = _examples()
    T = cfg.model.max_t_len
    full = pack_examples(ex, T, batch_size=B, clip_multiple=2, dp_shards=DP)
    for owned in ({0}, {1, 3}, set()):
        kw = dict(batch_size=B, clip_multiple=2, dp_shards=DP,
                  only_shards=owned)
        got, want = pack_examples(ex, T, **kw), jax_pack(jex, T, **kw)
        assert sorted(got) == sorted(want) == sorted(full)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            rows = full[k].shape[0] // DP
            for g in owned:
                np.testing.assert_array_equal(
                    got[k][g * rows:(g + 1) * rows],
                    full[k][g * rows:(g + 1) * rows], err_msg=f"{k} {g}")


def test_rank_block_is_its_slice_and_its_own_packing():
    """Each rank's block of the global build and of its ``only_shards``
    build are equal; its clip_video indices point into its own videos;
    and it is exactly what packing its own two videos alone gives at the
    same clip budget and span."""
    from svpc_torch.data.packing import pack_examples
    from svpc_torch.parallel.mesh import Mesh, local_dp_shards, shard_batch

    cfg, _, ex = _examples()
    T = cfg.model.max_t_len
    full = pack_examples(ex, T, batch_size=B, clip_multiple=2, dp_shards=DP)
    n = full["clip_mask"].shape[0] // DP
    v_len = full["clip_input_ids"].shape[1] - T
    bs = B // DP
    for r in range(DP):
        mesh = Mesh(dp_size=DP, tp_size=1, dp_index=r, tp_index=0)
        assert local_dp_shards(mesh) == {r}
        mine = shard_batch(mesh, pack_examples(
            ex, T, batch_size=B, clip_multiple=2, dp_shards=DP,
            only_shards=local_dp_shards(mesh)))
        block = shard_batch(mesh, full)
        alone = pack_examples(ex[r * bs:(r + 1) * bs], T, batch_size=bs,
                              n_clips=n, v_len=v_len)
        for k in full:
            np.testing.assert_array_equal(mine[k], block[k], err_msg=k)
            np.testing.assert_array_equal(block[k], alone[k], err_msg=k)
        assert block["clip_video"].max() < bs


@pytest.mark.parametrize("batch_size", [3, 4])
def test_fixed_clip_budget_per_dp_shard_equals_svpc_tpu(batch_size):
    """The eval clip budget per dp shard is svpc_tpu's, for a dataset of
    uneven videos."""
    import types

    from svpc_tpu.data.packing import fixed_clip_budget as jax_budget
    from svpc_torch.data.packing import fixed_clip_budget

    rng = np.random.RandomState(0)
    ds = types.SimpleNamespace(
        num_steps=6, data=[{"sentences": ["s"] * int(k)}
                           for k in rng.randint(1, 9, size=11)])
    for dp in (1, 2, 4):
        for multiple in (1, 4):
            assert fixed_clip_budget(ds, batch_size, multiple, dp) == \
                jax_budget(ds, batch_size, multiple, dp), (dp, multiple)
