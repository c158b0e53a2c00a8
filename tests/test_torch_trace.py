"""The port's span recorder (lushnerf_torch/utils/trace.py) on the CPU: off
it records nothing and opens no profiler range; under a profiler or
`recording()` it records nesting, parents, keys and self times, a thread at
a time, in a bounded ring; the trainer, the renderer and the fused MLP's
weight packs record their spans where they should."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lushnerf_torch.config import Config
from lushnerf_torch.models.mlp import MLPConfig, NeRFMLP
from lushnerf_torch.ops.fused import nerf_mlp as fused
from lushnerf_torch.train import trainer as tt
from lushnerf_torch.utils import trace

STEP_SPANS = ("train.iteration", "train.next_batch", "train.step", "train.forward",
              "train.backward", "train.optimizer")


@pytest.fixture
def ranges(monkeypatch):
    """The names of the profiler ranges the spans open."""
    opened = []
    real = torch.autograd.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    return opened


def since_now():
    return time.perf_counter_ns()


def names(records):
    return [r.name for r in records]


def test_off_records_nothing_and_opens_no_range(ranges):
    t0 = since_now()
    s = trace.span("train.step", 3)
    assert s is trace.OFF and trace.span("other") is s  # one shared no-op
    with s:
        with trace.span("train.forward"):
            pass
    x = torch.ones(3, requires_grad=True)
    y = torch.cumprod(x, 0)
    trace.span_backward(y, "sync.cumprod_backward")
    y.sum().backward()
    assert trace.spans(t0) == [] and ranges == []


def test_recording_opens_no_range_outside_a_profiler(ranges):
    t0 = since_now()
    with trace.recording():
        with trace.span("train.step"):
            pass
    assert names(trace.spans(t0)) == ["train.step"] and ranges == []
    with trace.span("train.step"):  # off again
        pass
    assert len(trace.spans(t0)) == 1


def test_recording_under_a_cpu_profiler(ranges):
    t0 = since_now()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("train.step", 7):
            with trace.span("train.forward"):
                torch.ones(4).sum()
    got = trace.spans(t0)
    assert names(got) == ["train.forward", "train.step"]
    assert ranges == ["train.step", "train.forward"]
    events = {e.name for e in prof.events()}
    assert {"train.step", "train.forward"} <= events


def test_nesting_parents_keys_and_self_time():
    t0 = since_now()
    with trace.recording():
        with trace.span("train.iteration", 12):
            with trace.span("train.step"):
                with trace.span("train.forward"):
                    time.sleep(0.002)
                with trace.span("render.view", 4):
                    with trace.span("render.chunk"):
                        pass
                time.sleep(0.002)
    got = {r.name: r for r in trace.spans(t0)}
    assert set(got) == {"train.iteration", "train.step", "train.forward", "render.view",
                        "render.chunk"}
    assert got["train.iteration"].parent is None
    assert got["train.step"].parent == "train.iteration"
    assert got["train.forward"].parent == "train.step"
    assert got["render.chunk"].parent == "render.view"
    assert got["train.forward"].key == 12 and got["train.step"].key == 12
    assert got["render.view"].key == 4 and got["render.chunk"].key == 4  # its own key rules
    step = got["train.step"]
    children = got["train.forward"].ns + got["render.view"].ns
    assert step.self_ns == step.ns - children and step.self_ns >= 2_000_000
    assert got["train.iteration"].self_ns == got["train.iteration"].ns - step.ns
    assert got["render.chunk"].self_ns == got["render.chunk"].ns
    for r in got.values():
        assert r.start_ns <= r.end_ns and 0 <= r.self_ns <= r.ns
    assert got["train.step"].start_ns <= got["train.forward"].start_ns
    assert got["train.forward"].end_ns <= got["train.step"].end_ns


def test_spans_interval_bounds():
    t0 = since_now()
    with trace.recording():
        with trace.span("a"):
            pass
        t1 = since_now()
        with trace.span("b"):
            pass
    assert names(trace.spans(t0)) == ["a", "b"]
    assert names(trace.spans(t1)) == ["b"]
    assert names(trace.spans(t0, t1)) == ["a"]


def test_a_second_thread_is_kept_apart():
    t0 = since_now()
    inside = threading.Event()
    done = threading.Event()

    def other():
        inside.wait(10)
        with trace.span("mlp.bwd"):
            with trace.span("mlp.pack"):
                pass
        done.set()

    worker = threading.Thread(target=other)
    with trace.recording():
        worker.start()
        with trace.span("train.backward", 5):
            inside.set()
            assert done.wait(10)
        worker.join(10)
    assert not worker.is_alive()
    got = {r.name: r for r in trace.spans(t0)}
    assert got["mlp.bwd"].parent is None and got["mlp.bwd"].key is None
    assert got["mlp.pack"].parent == "mlp.bwd"
    assert got["mlp.bwd"].thread != got["train.backward"].thread
    assert got["mlp.bwd"].thread == got["mlp.pack"].thread
    # the other thread's span is not the backward's child
    assert got["train.backward"].self_ns == got["train.backward"].ns


def test_the_ring_stays_bounded():
    t0 = since_now()
    with trace.recording():
        for i in range(trace.RING + 10):
            with trace.span("x", i):
                pass
    got = trace.spans(t0)
    assert len(got) == trace.RING
    assert got[0].key == 10 and got[-1].key == trace.RING + 9  # the newest kept


def test_span_backward_wraps_the_node():
    t0 = since_now()
    x = torch.rand(3, 5, requires_grad=True)
    with trace.recording():
        y = torch.cumprod(x, -1)
        trace.span_backward(y, "sync.cumprod_backward")
        with trace.span("train.backward", 2):
            y[..., :-1].sum().backward()
    got = {r.name: r for r in trace.spans(t0)}
    assert set(got) == {"sync.cumprod_backward", "train.backward"}
    assert got["sync.cumprod_backward"].parent == "train.backward"
    assert got["sync.cumprod_backward"].key == 2
    assert x.grad is not None


# ---------------------------------------------------------------------------
# where the program records
# ---------------------------------------------------------------------------


def scene(n=4, H=12, W=12):
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    images = np.stack([np.stack([0.3 + 0.3 * np.sin(4 * xx + i), 0.3 + 0.3 * np.cos(3 * yy - i),
                                 0.4 + 0.2 * np.sin(5 * (xx + yy))], -1) for i in range(n)])
    poses = np.stack([np.concatenate([np.eye(3), [[0.05 * i], [0.0], [0.0]]], 1)
                      for i in range(n)]).astype(np.float32)
    return dict(images=images.astype(np.float32), poses=poses,
                bds=np.tile(np.array([[1.0, 5.0]], np.float32), (n, 1)),
                render_poses=poses[:1], hwf=(H, W, 0.8 * W))


def tiny_trainer(tmp_path):
    cfg = Config(expname="trace", basedir=str(tmp_path / "logs"), tbdir="", N_rand=32,
                 N_samples=18, N_importance=6, netdepth=2, netwidth=16, netdepth_fine=2,
                 netwidth_fine=16, multires=4, multires_views=2, use_viewdirs=True,
                 raw_noise_std=1.0, rgb_activate="sigmoid", blur_model_type="dpnerf",
                 use_dpnerf=True, rbk_use_origin=True, rbk_num_motion=2, rbk_view_embed_ch=8,
                 rbk_enc_brc_width=8, rbk_se_r_width=8, rbk_se_v_width=8, rbk_ccw_width=8,
                 tone_mapping_type="gamma", kernel_start_iter=2, allkernel_start_iter=10**9,
                 noisenerf_start_iter=10**9, i_print=2, i_weights=10**9, i_testset=10**9,
                 llffhold=4, point_chunk=0, ray_chunk_eval=64, mlp_backend="cuda")
    tr = tt.Trainer(cfg, data=scene(), device="cpu")
    tr.setup()
    return tr


def test_trainer_records_each_phase_once_an_iteration(tmp_path):
    tr = tiny_trainer(tmp_path)
    t0 = since_now()
    with profile(activities=[ProfilerActivity.CPU]):
        tr.train(3)
    got = trace.spans(t0)
    for name in STEP_SPANS:
        assert sorted(r.key for r in got if r.name == name) == [1, 2, 3], name
    assert [r.key for r in got if r.name == "train.log"] == [2]
    assert sorted(r.name for r in got if r.key == 2 and r.name.startswith("sync.")) == [
        "sync.cumprod_backward", "sync.cumprod_backward", "sync.print_loss", "sync.print_psnr"]
    # the tiny MLPs are outside the kernels' family: the renderer's plain
    # fallback, twice a forward (coarse and fine)
    assert sorted(r.key for r in got if r.name == "mlp.plain") == [1, 1, 2, 2, 3, 3]
    parent = {r.name: r.parent for r in got}
    assert parent["train.step"] == parent["train.next_batch"] == "train.iteration"
    assert parent["train.forward"] == parent["train.backward"] == "train.step"
    assert parent["train.optimizer"] == "train.step"


def test_no_spans_without_a_profiler(tmp_path):
    tr = tiny_trainer(tmp_path)
    t0 = since_now()
    tr.train(2)
    assert trace.spans(t0) == []


def test_render_records_a_view_and_each_chunk(tmp_path):
    tr = tiny_trainer(tmp_path)
    t0 = since_now()
    with trace.recording():
        tr.render_pose(tr.poses[1], 1)
    got = trace.spans(t0)
    chunks = -(-tr.H_eval * tr.W_eval // tr.cfg.ray_chunk_eval)
    assert names(got).count("render.view") == 1
    assert [r.parent for r in got if r.name == "render.chunk"] == ["render.view"] * chunks
    assert {r.key for r in got if r.name.startswith(("render.", "sync."))} == {1}
    assert sorted(r.name for r in got if r.name.startswith("sync.")) == [
        "sync.render_c2w", "sync.render_focal", "sync.render_k"]


@pytest.mark.parametrize("dtype,syncs", [("float32", 10), ("bfloat16", 0)])
def test_forward_pack_spans(dtype, syncs):
    mlp = NeRFMLP(MLPConfig(), torch.Generator().manual_seed(0), torch.device("cpu"))
    t0 = since_now()
    with trace.recording():
        fused.pack_params(mlp, dtype)
        t1 = since_now()
        fused.pack_params(mlp, dtype)  # a cache hit
    got = trace.spans(t0)
    assert names(got).count("mlp.pack") == 1
    assert names(got).count("sync.pack_range") == syncs
    assert {r.parent for r in got if r.name == "sync.pack_range"} <= {"mlp.pack"}
    assert trace.spans(t1) == []


@pytest.mark.parametrize("dtype,syncs", [("float32", 12), ("bfloat16", 0)])
def test_backward_pack_spans(dtype, syncs):
    mlp = NeRFMLP(MLPConfig(), torch.Generator().manual_seed(0), torch.device("cpu"))
    t0 = since_now()
    with trace.recording():
        fused.pack_params_bwd(mlp, dtype)
        t1 = since_now()
        fused.pack_params_bwd(mlp, dtype)
    got = trace.spans(t0)
    assert names(got).count("mlp.pack") == 1
    assert names(got).count("sync.pack_range") == syncs
    assert trace.spans(t1) == []
    with torch.no_grad():  # a new parameter version: packed again
        mlp.rgb_linear.bias.add_(1.0)
    t2 = since_now()
    with trace.recording():
        fused.pack_params_bwd(mlp, dtype)
    assert names(trace.spans(t2)).count("mlp.pack") == 1
