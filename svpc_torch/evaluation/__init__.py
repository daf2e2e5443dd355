"""Caption scorers: the port of svpc_tpu/evaluation (numpy and the
standard library only).  ``evaluate_submission`` is the metric bundle of
``cli.evaluate`` and of the trainer's language eval."""

from svpc_torch.evaluation.para_eval import evaluate_submission  # noqa: F401
