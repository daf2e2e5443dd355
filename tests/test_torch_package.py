"""Rules of the svpc_torch package: it imports none of JAX, flax, nltk,
ml_dtypes or svpc_tpu (neither does chip_smoke.py, nor the parallel
package and its rank worker, svpc_torch/parallel/), in its source and when
every module is imported; asking for the card without one raises; the
compute dtype is float32 or bfloat16."""

import ast
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "nltk", "ml_dtypes",
             "svpc_tpu"}


def _port_files():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "svpc_torch")):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_no_jax_and_nothing_of_svpc_tpu():
    bad = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_every_port_module_imports_without_them():
    """A fresh interpreter imports every module of svpc_torch (the
    evaluation scorers, beam search, the native packer's loader, the
    client, the tagger and every CLI included) and ends with none of the
    forbidden packages loaded."""
    names = sorted(
        os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".")
        .replace(".__init__", "")
        for p in _port_files() if p.endswith(".py")
        and os.path.basename(p) != "chip_smoke.py")
    for name in ("svpc_torch.evaluation.meteor", "svpc_torch.evaluation.porter",
                 "svpc_torch.decode.beam", "svpc_torch.cli.evaluate",
                 "svpc_torch.cli.caption", "svpc_torch.native",
                 "svpc_torch.client", "svpc_torch.tagging",
                 "svpc_torch.cli.export_checkpoint",
                 "svpc_torch.cli.dump_memories",
                 "svpc_torch.cli.validate_data",
                 "svpc_torch.cli.convert_features",
                 "svpc_torch.cli.build_vocab",
                 "svpc_torch.cli.build_pos_vocab",
                 "svpc_torch.parallel", "svpc_torch.parallel.mesh",
                 "svpc_torch.parallel.collectives",
                 "svpc_torch.parallel.pipeline",
                 "svpc_torch.parallel.worker"):
        assert name in names, name
    code = ("import importlib, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r})\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_cuda_without_a_card_raises():
    from svpc_torch.precision import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        for dev in (None, "cuda"):
            with pytest.raises(RuntimeError, match="cuda"):
                resolve_device(dev)


def test_bfloat16_compute_is_refused():
    """Only the two compute dtypes svpc_tpu has are accepted: float16 is
    refused, bfloat16 builds (float32 parameters, bfloat16 projections)."""
    from svpc_torch.config import tiny_test_config
    from svpc_torch.model import SVPCModel

    cfg = tiny_test_config("full")
    with pytest.raises(ValueError, match="float16"):
        SVPCModel(cfg.model.__class__(**{**cfg.model.__dict__,
                                         "compute_dtype": "float16"}))
    model = SVPCModel(cfg.replace_model(compute_dtype="bfloat16").model)
    assert model.compute_dtype == torch.bfloat16
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert model.encoder.layer[0].attention.self.query.compute_dtype \
        == torch.bfloat16
