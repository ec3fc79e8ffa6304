"""The trace reader and the per-layer readers on a synthetic trace."""

import pytest

from benchmark import run as bench_run
from benchmark.trace import DeviceEvent, Trace
from benchmark.work.common import peaks

from .conftest import small_cell


def _trace():
    ev = [DeviceEvent("conv_a", 0, 40, (1, 1.0), "aten::cudnn_convolution"),
          DeviceEvent("tile_sparse_conv3x3_kernel<4>", 50, 60, (1, 12.0),
                      None),
          DeviceEvent("add", 55, 70, (1, 13.0), "aten::add"),
          DeviceEvent("copy", 90, 100, None, "aten::copy_")]
    return Trace(device=ev, spans={"encoder": {1: [(0.5, 5.0)]},
                                   "decoder": {1: [(10.0, 20.0)]}},
                 window_s=2e-4, units=2, unlinked=1)


def test_busy_is_the_union_of_intervals():
    t = _trace()
    assert t.busy_us() == 40 + 20 + 10
    assert t.device_us() == 40 + 10 + 15 + 10


def test_spans_own_what_they_launched():
    t = _trace()
    assert t.span_us("encoder") == 40
    # the tile kernel has no ATen op but its launch lies in the span; the
    # copy's launch is not in the trace, so it is in no span
    assert t.span_us("decoder") == 10 + 15


def test_breakdown_and_readers():
    t = _trace()
    b = t.breakdown()
    assert b["device_ops"][0] == ["conv_a", 40e-6]
    assert dict((n, v) for n, v in b["idle_gaps"])["aten::copy_"] == \
        pytest.approx(20e-6)
    cell = small_cell("kitti_r18_serve_sparse_b16")
    ctx = {"cell": cell, "host_trace": t, "batch": 2, "height": 64,
           "width": 128, "masks": None, "traced": [0, 0]}
    assert cell.readers["device_idle.serve"].read(t, ctx) == \
        pytest.approx(100 * (1 - 70e-6 / 2e-4))
    assert cell.readers["encoder_ms.serve"].read(t, ctx) == 0.02
    assert cell.readers["tile_conv_roofline.serve"].read(t, ctx) is None


def test_roofline_stays_under_100_for_a_kernel_at_the_bound():
    """A kernel that took exactly the least time the work needs reads
    100%."""
    import numpy as np
    from benchmark.work.common import peaks
    cell = small_cell("kitti_r18_serve_sparse_b16")
    masks = [{i: np.ones((2, 64 >> (i + 1), 128 >> (i + 1), 1),
                         np.float32) for i in (3, 2, 1)}]
    w = cell.work.tile_conv_work(64, 128, masks[0])
    pk = peaks()
    least_us = 1e6 * max(w["flops"] / pk["f32_flops"],
                         w["bytes"] / pk["hbm_bytes_per_s"])
    t = Trace(device=[DeviceEvent("tile_sparse_conv3x3_kernel<4>", 0,
                                  least_us, (1, 0.0), None)],
              window_s=1.0, units=1)
    ctx = {"cell": cell, "host_trace": t, "batch": 2, "height": 64,
           "width": 128, "masks": masks, "traced": [0]}
    assert cell.readers["tile_conv_roofline.serve"].read(t, ctx) == \
        pytest.approx(100.0)


def test_mfu_counts_the_window_s_requests():
    """mfu.serve: the work of the window's requests, each of its pool
    batch, over the window's seconds; with none, no reading."""
    cell = small_cell("kitti_r18_serve_dense_b16")
    ctx = {"cell": cell, "batch": 2, "height": 64, "width": 128,
           "masks": None, "traced": [0], "window": [3, 1],
           "window_s": 0.5}
    one = cell.work.serve_flops(2, 64, 128, None)
    mfu = cell.readers["mfu.serve"]
    assert mfu.read(_trace(), ctx) == \
        pytest.approx(100 * 4 * one / 0.5 / peaks()["f32_flops"])
    assert mfu.read(_trace(), dict(ctx, window=[0, 0])) is None


def test_training_mfu_counts_the_window_s_steps():
    cell = small_cell("kitti_r18_train_b12")
    mfu = bench_run.load_file_module(
        bench_run.BENCH_DIR / "metrics" / "mfu.train.py", "mfu_train")
    ctx = {"cell": cell, "batch": 12, "height": 192, "width": 640,
           "window": 10, "window_s": 2.0}
    step = cell.work.train_step_flops(12, 192, 640)
    assert mfu.read(_trace(), ctx) == \
        pytest.approx(100 * 10 * step / 2.0 / peaks()["f32_flops"])
    assert mfu.read(_trace(), dict(ctx, window=0)) is None
