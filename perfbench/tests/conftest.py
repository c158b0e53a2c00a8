"""Fixtures of the benchmark's tests: a tiny copy of the benchmark (a CPU
test's size) and the `card` marker's look for a CUDA device, made inside a
fixture, never while a module is imported."""

import json
import shutil
from pathlib import Path

import pytest

from perfbench import harness


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest perfbench/tests -m card)")
    return torch.device("cuda:0")


TINY = dict(N_rand=64, N_samples=24, N_importance=8, ray_chunk_eval=256)
TINY_SCENE = {"views": 9, "height": 24, "width": 32, "focal": 25.6}


def make_tiny(root: Path) -> dict:
    """A copy of the benchmark's files under root at a CPU test's size: the
    configurations' widths and depths as they are, their rays, samples and
    scene cut down; one iteration a chunk.  Returns the spec."""
    shutil.copytree(harness.PKG, root, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for c in spec["configs"]:
        path = root / "configs" / f"{c['name']}.json"
        conf = json.loads(path.read_text())
        conf["config"].update(TINY, point_chunk=conf["config"]["point_chunk"] and 2048)
        conf["scene"] = dict(TINY_SCENE)
        path.write_text(json.dumps(conf))
        c["file"] = str(path)
    tr = root / "traffic" / "train.json"
    tr.write_text(json.dumps(dict(json.loads(tr.read_text()), warm_iters=1, chunk_iters=1)))
    return spec


@pytest.fixture
def tiny(tmp_path):
    root = tmp_path / "perfbench"
    return root, make_tiny(root)
