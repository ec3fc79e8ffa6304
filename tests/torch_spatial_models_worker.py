"""One rank of tests/test_torch_port_spatial_models.py's eight-rank gloo
group on the CPU (not a test module).

Usage: python tests/torch_spatial_models_worker.py RANK WORLD PORT DIR

Joins the group through `parallel/mesh.initialize_distributed`, reads
DIR/inputs.pt (the image and, per model of MODELS, the port's state
dicts of JAX's seeded encoder and decoder) and runs every case of CASES
through `mesh.spatial_forward` on the 1x8 mesh, on this rank's band of
the image, in float64 and float32 (`runs`), writing DIR/out<RANK>.pt:
each run's full-height outputs, and the calls of the kernel wrappers it
made with their inputs' heights.
"""

import os
import sys

import torch

# thresholds at which the seeded models' masks are partial
KITTI_THRESH = 0.1
NYU_THRESH = 0.05
# encoder: (class in models/, its options)
ENCODERS = {
    "mbv2": ("mobilenetv2.MobileNetV2Encoder", {"use_last_layer": True}),
    "mbv2_light": ("mobilenetv2.MobileNetV2Encoder",
                   {"use_last_layer": False}),
    "r18": ("resnet.ResnetEncoder", {"num_layers": 18}),
}
# model: (encoder, decoder class in models/); each has its own weights
MODELS = {
    "kitti_mbv2": ("mbv2", "decoders_kitti.KittiWaveletDecoder"),
    "kitti_mbv2_light": ("mbv2_light", "decoders_kitti.KittiWaveletDecoder"),
    "r18_depth": ("r18", "decoders_kitti.DepthDecoder"),
    "r18_wave": ("r18", "decoders_kitti.KittiWaveletDecoder"),
    "nyu_mbv2_wave": ("mbv2", "decoders_nyu.NyuDecoderWave"),
    "nyu_mbv2_base": ("mbv2", "decoders_nyu.NyuDecoder"),
}
SPARSE = {"thresh_ratio": KITTI_THRESH}
NYU_SPARSE = {"thresh_ratio": NYU_THRESH}
POLY = {"use_polyphase": True}
# case: (model, decoder options, forward kwargs)
CASES = {
    "kitti_mbv2_dense": ("kitti_mbv2", {}, {}),
    "kitti_mbv2_sparse": ("kitti_mbv2", {}, SPARSE),
    "kitti_mbv2_light_dense": ("kitti_mbv2_light", {}, {}),
    "kitti_mbv2_light_sparse": ("kitti_mbv2_light", {}, SPARSE),
    "r18_depth": ("r18_depth", {}, {}),
    "r18_depth_poly": ("r18_depth", POLY, {}),
    "r18_wave_poly_dense": ("r18_wave", POLY, {}),
    "r18_wave_poly_sparse": ("r18_wave", POLY, SPARSE),
    "nyu_mbv2_dense": ("nyu_mbv2_wave", {}, {}),
    "nyu_mbv2_sparse": ("nyu_mbv2_wave", {}, NYU_SPARSE),
    "nyu_mbv2_poly_dense": ("nyu_mbv2_wave", POLY, {}),
    "nyu_mbv2_poly_sparse": ("nyu_mbv2_wave", POLY, NYU_SPARSE),
    "nyu_mbv2_base": ("nyu_mbv2_base", {}, {}),
}
# the kernel cases (the kernels' plain versions on the CPU): held to the
# port's one-process forward on the same backend
KERNEL_CASES = {
    f"{name}_{b}": (model, {}, {**sparse, "use_pallas": b})
    for name, model, sparse in (("kitti_mbv2", "kitti_mbv2", SPARSE),
                                ("nyu_mbv2", "nyu_mbv2_wave", NYU_SPARSE))
    for b in ("pallas", "pallas2d")}


def _class(path: str):
    import importlib
    mod, name = path.rsplit(".", 1)
    return getattr(importlib.import_module(
        f"wavelet_monodepth_tpu_torch.models.{mod}"), name)


def build(case: str, inputs: dict, dtype=torch.float32):
    """The case's encoder and decoder on the inputs' weights, eval, in
    `dtype`."""
    from torch_spatial_nyu_worker import load
    model, opts, _ = {**CASES, **KERNEL_CASES}[case]
    enc_name, dec_path = MODELS[model]
    enc_path, enc_opts = ENCODERS[enc_name]
    enc = load(_class(enc_path)(**enc_opts), inputs[model]["enc"])
    dec = load(_class(dec_path)(enc.num_ch_enc, **opts),
               inputs[model]["dec"])
    return enc.to(dtype), dec.to(dtype)


def runs():
    """(result key, case, dtype) of every run: each case of CASES in
    float64 ("<case>64") and float32, each kernel case in float32 (the
    kernels run float32 only)."""
    return ([(f"{c}64", c, torch.float64) for c in CASES]
            + [(c, c, torch.float32) for c in {**CASES, **KERNEL_CASES}])


def forward_kwargs(case: str) -> dict:
    return {**CASES, **KERNEL_CASES}[case][2]


def main():
    rank, world, port, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    from torch_spatial_nyu_worker import counting
    from wavelet_monodepth_tpu_torch.parallel import mesh
    assert mesh.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                       "cpu")
    mesh.warmup_collectives()
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    m = mesh.make_mesh(1, world)
    bands = {dt: mesh.shard_spatial(m, inputs["x"].to(dt))
             for dt in (torch.float32, torch.float64)}
    out = {"band_rows": bands[torch.float32].shape[1], "calls": {}}
    for key, case, dtype in runs():
        enc, dec = build(case, inputs, dtype)
        kw = forward_kwargs(case)
        calls = []
        undo = counting(calls)
        try:
            out[key] = mesh.spatial_forward(
                m, lambda img: dec(enc(img), **kw))(bands[dtype])
        finally:
            undo()
        out["calls"][key] = calls
    torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    mesh.shutdown()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
