"""One rank of tests/test_torch_port_spatial_nyu.py's eight-rank gloo
group on the CPU (not a test module).

Usage: python tests/torch_spatial_nyu_worker.py RANK WORLD PORT DIR

Joins the group through `parallel/mesh.initialize_distributed`, reads
DIR/inputs.pt (the image, the port's state dicts of JAX's seeded
DenseNet161 + NyuDecoderWave, and the narrow decoders' state dicts with
their full-height features) and runs every case through
`mesh.spatial_forward` on the 1x8 mesh, writing DIR/out<RANK>.pt:
  * "dense", "sparse_<backend>": DenseNet161 + NyuDecoderWave on this
    rank's band of the image, dense and sparse at THRESH on each of
    BACKENDS (the kernels' plain versions here), with the calls of the
    kernel wrappers each sparse case made and their inputs' heights;
  * "dense64", "sparse64": the same model and image in float64, dense
    and sparse on the masked-dense backend;
  * each of DECODERS on the narrow features, passed in full height and
    banded by the decoder, dense and, with a threshold, sparse.
"""

import os
import sys

import torch

THRESH = 0.05
BACKENDS = (False, True, "pallas2d", "capacity")
# name: (class in models/decoders_nyu.py, its options, decoder kwargs)
DECODERS = {
    "decoder": ("NyuDecoder", {}, {}),
    "decoder_dw": ("NyuDecoder", {"is_depthwise": True}, {}),
    "decoder224": ("NyuDecoder224", {}, {}),
    "wave": ("NyuDecoderWave", {}, {}),
    "wave224": ("NyuDecoderWave224", {}, {}),
    "wave_dw": ("NyuDecoderWave", {"dw_waveconv": True, "dw_upconv": True},
                {}),
    "wave_dw_sparse": ("NyuDecoderWave", {"dw_waveconv": True,
                                          "dw_upconv": True},
                       {"thresh_ratio": THRESH, "use_pallas": True}),
}


def load(module: torch.nn.Module, sd: dict) -> torch.nn.Module:
    """`module` on the bridge's state dict (BN counters zero), eval."""
    fitted = dict(sd)
    for k in module.state_dict():
        if k.endswith("num_batches_tracked"):
            fitted[k] = torch.zeros((), dtype=torch.long)
    module.load_state_dict(fitted, strict=True)
    return module.eval()


def build(inputs: dict, dtype=torch.float32):
    """The port's DenseNet161 and NyuDecoderWave on the inputs' weights,
    in `dtype`."""
    from wavelet_monodepth_tpu_torch.models.decoders_nyu import \
        NyuDecoderWave
    from wavelet_monodepth_tpu_torch.models.densenet import \
        DenseNet161Encoder
    enc = load(DenseNet161Encoder(), inputs["enc"])
    dec = load(NyuDecoderWave(enc.num_ch_enc), inputs["dec"])
    return enc.to(dtype), dec.to(dtype)


def narrow(name: str, inputs: dict):
    """DECODERS[name] on the narrow widths and its weights."""
    from wavelet_monodepth_tpu_torch.models import decoders_nyu
    cls, opts, _ = DECODERS[name]
    module = getattr(decoders_nyu, cls)(inputs["narrow_ch"], **opts)
    return load(module, inputs["narrow"][name])


def counting(calls: list):
    """Wrap the kernel wrappers that Conv3x3 reaches (K1, K4 and the
    capacity conv) to record (wrapper, input height) per call; returns
    the undo."""
    from wavelet_monodepth_tpu_torch.ops import capacity as cap
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    saved = []
    for mod, name in ((tsc, "conv3x3_tile_sparse"),
                      (tsc, "conv3x3_tile_sparse_2d"),
                      (cap, "conv3x3_capacity_sparse")):
        fn = getattr(mod, name)

        def wrapped(x, *a, _fn=fn, _name=name, **kw):
            calls.append((_name, x.shape[1]))
            return _fn(x, *a, **kw)
        saved.append((mod, name, fn))
        setattr(mod, name, wrapped)

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return undo


def main():
    rank, world, port, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    from wavelet_monodepth_tpu_torch.parallel import mesh
    assert mesh.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                       "cpu")
    mesh.warmup_collectives()
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    m = mesh.make_mesh(1, world)
    enc, dec = build(inputs)
    band = mesh.shard_spatial(m, inputs["x"])
    out = {"band_rows": band.shape[1], "calls": {}}
    out["dense"] = mesh.spatial_forward(m, lambda img: dec(enc(img)))(band)
    for backend in BACKENDS:
        calls = []
        undo = counting(calls)
        try:
            out[f"sparse_{backend}"] = mesh.spatial_forward(
                m, lambda img, b=backend: dec(enc(img), thresh_ratio=THRESH,
                                              use_pallas=b))(band)
        finally:
            undo()
        out["calls"][backend] = calls
    enc, dec = build(inputs, torch.float64)
    band = mesh.shard_spatial(m, inputs["x"].double())
    out["dense64"] = mesh.spatial_forward(m, lambda img: dec(enc(img)))(band)
    out["sparse64"] = mesh.spatial_forward(
        m, lambda img: dec(enc(img), thresh_ratio=THRESH))(band)
    feats = inputs["narrow_feats"]
    for name, (_, _, kw) in DECODERS.items():
        d = narrow(name, inputs)
        out[name] = mesh.spatial_forward(m, lambda f, d=d, kw=kw: d(f, **kw))(
            feats)
    torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    mesh.shutdown()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
