"""Data and tensor parallelism on ``torch.distributed``: the port of
svpc_tpu/parallel/mesh.py (``mesh``: the dp x tp mesh, the partition and
ZeRO-1 rules, batch blocks, global-shape random draws; ``collectives``:
the collectives with gradients).  svpc_tpu/parallel/pipeline.py (GPipe)
is not ported yet."""
