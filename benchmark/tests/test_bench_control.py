"""The control and the faults come out as not correct.

The control is the plain reference in TF32 put in the program's place
(on the CPU: its conv and matmul operands rounded to TF32); each fault is
planted in the timed path underneath a whole run of the traffic driver,
the harness's look for a chip skipped. The cells' limits hold against all of
them at this size too."""

import pytest

from benchmark.traffic import serve_closed, train_steps

from .conftest import small_cell

SERVING = ["kitti_r18_serve_sparse_b16", "kitti_r18_serve_dense_b16",
           "nyu_d161_serve_sparse_b8"]


@pytest.mark.parametrize("name", SERVING)
def test_serving_control_fails(name, cpu):
    cell = small_cell(name)
    read = serve_closed.calibrate(cell, 5, 0.1, cpu)
    limits = cell.params["limits"]
    assert read["program"]["disp_max_abs"] <= limits["disp_max_abs"]
    assert read["control"]["disp_max_abs"] > limits["disp_max_abs"]


def test_training_control_fails(cpu):
    cell = small_cell("kitti_r18_train_b12")
    read = train_steps.calibrate(cell, 5, 0.1, cpu)
    limits = cell.params["limits"]
    failed = [k for k, lim in limits.items() if read["control"][k] > lim]
    assert failed, read["control"]
    assert all(read["program"][k] <= lim for k, lim in limits.items()), \
        read["program"]


FAULTS = [(name, fault) for name in SERVING
          for fault in ("answer_altered", "half_batch", "mask_pixel")
          if fault != "mask_pixel" or "sparse" in name]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_serving_fault_is_caught(name, fault, cpu):
    res = serve_closed.run(small_cell(name), seed=7, seconds=0.1,
                           trace=False, device=cpu, started=lambda: 1.0,
                           fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "unchanged"])
def test_training_fault_is_caught(fault, cpu):
    res = train_steps.run(small_cell("kitti_r18_train_b12"), seed=7,
                          seconds=0.1, trace=False, device=cpu,
                          started=lambda: 1.0, fault=fault)
    assert not res["correct"], res["checks"]
