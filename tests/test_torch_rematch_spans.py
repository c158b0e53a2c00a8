"""The spans of the CTE stage (lushnerf_torch/utils/trace.py's scheme, a
count is the number of a name's spans) on the CPU: a tiny Trainer given a
`TINY_DIMS` DKMv3 matcher crosses noisenerf_start_iter, rematches its 3
train views (9 ordered pairs) and runs consist iterations.  It records one
`train.rematch` holding one `rematch.render`, one `rematch.match` and one
`rematch.save` (the tables written uncompressed), one
`dkm.encode` ending on its one `sync.dkm_encode`, a `dkm.decode` a pair
batch, and a `train.consist` inside `train.forward` a consist iteration;
off, it records none of them."""

import math
import time

import numpy as np
import pytest

from lushnerf_torch.config import Config
from lushnerf_torch.matcher.api import MatchTables
from lushnerf_torch.matcher.dkm import DKM, TINY_DIMS, DKMMatcher, random_state_dict
from lushnerf_torch.train import trainer as tt
from lushnerf_torch.utils import trace
from tests.test_torch_trainer import tiny_kwargs
from tests.test_train_e2e import synthetic_scene

CTE_SPANS = ("train.rematch", "rematch.render", "rematch.match", "dkm.encode",
             "sync.dkm_encode", "dkm.decode", "rematch.save", "train.consist")
START, LAST = 4, 6  # the rematch at 4 (rematch_interval 4); consist at 4, 5, 6


def _trainer(tmp_path, pair_batch):
    matcher = DKMMatcher(DKM.from_state_dict(random_state_dict(TINY_DIMS, seed=2)), hs=64,
                         ws=96, max_columns=256, pair_batch=pair_batch)
    kw = tiny_kwargs(tmp_path, kernel_start_iter=2, allkernel_start_iter=3,
                     noisenerf_start_iter=START, rematch_interval=START, consist_num_pixels=8)
    tr = tt.Trainer(Config(**kw), data=synthetic_scene(), matcher=matcher, device="cpu")
    tr.setup()
    return tr


def _count(records, name):
    return sum(r.name == name for r in records)


@pytest.mark.parametrize("pair_batch", [2, 4])
def test_a_rematch_and_consist_iterations_record_their_spans(tmp_path, pair_batch):
    tr = _trainer(tmp_path, pair_batch)
    views = len(tr.i_train)
    assert views == 3
    t0 = time.perf_counter_ns()
    with trace.recording():
        tr.train(LAST)
    got = trace.spans(t0)
    assert tr.match_tables.kpts.shape == (views, views, 256, 4)
    assert _count(got, "train.rematch") == 1
    assert _count(got, "rematch.render") == _count(got, "rematch.match") == \
        _count(got, "rematch.save") == 1
    assert _count(got, "dkm.encode") == _count(got, "sync.dkm_encode") == 1
    assert _count(got, "dkm.decode") == math.ceil(views ** 2 / pair_batch)
    assert _count(got, "train.consist") == LAST - START + 1
    parents = {r.name: r.parent for r in got if r.name in CTE_SPANS}
    assert parents == {"train.rematch": "train.iteration", "rematch.render": "train.rematch",
                       "rematch.match": "train.rematch", "dkm.encode": "rematch.match",
                       "sync.dkm_encode": "dkm.encode", "dkm.decode": "rematch.match",
                       "rematch.save": "train.rematch", "train.consist": "train.forward"}
    # the rematch's key is its iteration's; its parts lie inside it
    rematch = next(r for r in got if r.name == "train.rematch")
    assert rematch.key == START
    for r in got:
        if r.name in CTE_SPANS[1:7]:
            assert rematch.start_ns <= r.start_ns <= r.end_ns <= rematch.end_ns, r.name


def test_off_the_cte_stage_records_nothing(tmp_path):
    tr = _trainer(tmp_path, 2)
    t0 = time.perf_counter_ns()
    tr.train(LAST)
    assert trace.spans(t0) == []
    assert tr.match_tables.kpts.shape[2] == 256  # the rematch ran all the same
    # written uncompressed, read back as they are
    saved = MatchTables.load(tr.exp_dir / f"match_tables_{START:06d}.npz")
    assert np.array_equal(saved.kpts, tr.match_tables.kpts)
    with np.load(tr.exp_dir / f"match_tables_{START:06d}.npz") as z:
        assert z.zip.getinfo("kpts.npy").compress_type == 0  # ZIP_STORED
