"""The plain references against the port at a CPU size: what a window
served (through the cell's own driver, adapter and pool) is what the
reference computes from the same frames, masks and weights, within the
cell's limits; and the training reference's losses against the port's
first step."""

import pytest
import torch

from benchmark.traffic import serve_closed, train_steps

from .conftest import small_cell

SERVING = ["kitti_r18_serve_sparse_b16", "kitti_r18_serve_dense_b16",
           "nyu_d161_serve_sparse_b8"]


@pytest.mark.parametrize("name", SERVING)
def test_served_requests_match_the_reference(name, cpu):
    cell = small_cell(name)
    res = serve_closed.run(cell, seed=2 ** 31 + 11, seconds=0.2,
                           trace=False, device=cpu, started=lambda: 1.0)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["metrics"]["infer_fps"] > 0
    # far inside the limits: the CPU runs the same float32 arithmetic
    assert res["checks"]["disp_max_abs"]["value"] < 1e-5
    if "mask_mismatch" in res["checks"]:
        assert res["checks"]["mask_mismatch"]["value"] == 0


def test_training_steps_match_the_reference(cpu):
    cell = small_cell("kitti_r18_train_b12")
    res = train_steps.run(cell, seed=2 ** 31 + 12, seconds=0.2, trace=False,
                          device=cpu, started=lambda: 1.0)
    assert res["correct"], res["checks"]
    assert res["metrics"]["train_step_ms"] > 0


def test_training_reference_losses_equal_the_ports_forward(cpu):
    """Step 1's loss terms, before any update, from the same batch."""
    from benchmark import weights
    from benchmark.reference import kitti_r18_640x192 as net
    from benchmark.reference import kitti_train
    from benchmark.reference.common import Precision
    from wavelet_monodepth_tpu_torch.ops import augment
    cell = small_cell("kitti_r18_train_b12")
    h, w = cell.config["height"], cell.config["width"]
    batches, noises = cell.gen.make_batches(cell.params, h, w, 3, cpu)
    wt = weights.make(net.specs(), 3, cpu)
    train_steps.condition(wt)
    trainer = cell.adapter.Trainer(wt, cpu, cell.params, cell.config)
    with torch.no_grad():
        _, port = trainer.setup.forward(trainer.state,
                                        augment.expand_batch(batches[0]),
                                        noises[0], train=True)
    sd = {k: v for m in wt.values() for k, v in m.items()}
    with torch.no_grad():
        ref = kitti_train.losses(sd, batches[0], noises[0], Precision())
    for s in range(4):
        assert float(port[f"reproj_loss/{s}"]) == pytest.approx(
            float(ref[f"reproj_loss/{s}"]), rel=1e-5)
    # the hint term's argmin flips at near ties move it by ~1e-4 here
    assert float(port["loss"]) == pytest.approx(float(ref["loss"]),
                                                rel=2e-3)
