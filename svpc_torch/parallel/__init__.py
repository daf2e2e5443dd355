"""Data, pipeline and tensor parallelism on ``torch.distributed``: the
port of svpc_tpu/parallel/ (``mesh``: the dp x pp x tp mesh, the
partition, stage and ZeRO-1 rules, batch blocks, global-shape random
draws; ``collectives``: the collectives with gradients, the pipeline's
hand-offs among them; ``pipeline``: GPipe over the model's trunks;
``worker``: the rank launcher and the jobs the tests and chip_smoke.py
run)."""
