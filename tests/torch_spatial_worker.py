"""One rank of tests/test_torch_port_spatial.py's eight-rank gloo group
on the CPU (not a test module).

Usage: python tests/torch_spatial_worker.py RANK WORLD PORT DIR

Joins the group through `parallel/mesh.initialize_distributed`, reads the
image and the port's state dicts of JAX's seeded ResNet18 and ResNet50
KITTI models from DIR/inputs.pt, and runs every case through
`mesh.spatial_forward` on its band, writing DIR/out<RANK>.pt:
  * 1x8 (`make_mesh(1, 8)`): R18 dense; sparse at thresh 0.05 on xla,
    pallas, pallas2d and compact (the kernels' plain versions here);
    R50 dense;
  * 2x4 (`make_mesh(2, 4)`, from the same world): R18 dense on B=2, the
    image and its mirror, each data row banding its own image.
"""

import os
import sys

import torch

THRESH = 0.05
SPARSE_BACKENDS = ("xla", "pallas", "pallas2d", "compact")


def build(depth: int, enc_sd: dict, dec_sd: dict):
    """The port's encoder and wavelet decoder on the given weights, eval."""
    from wavelet_monodepth_tpu_torch.models.decoders_kitti import \
        KittiWaveletDecoder
    from wavelet_monodepth_tpu_torch.models.resnet import (ResnetEncoder,
                                                           num_ch_enc)
    enc = ResnetEncoder(depth)
    dec = KittiWaveletDecoder(num_ch_enc(depth))
    enc.load_state_dict(enc_sd, strict=True)
    dec.load_state_dict(dec_sd, strict=True)
    return enc.eval(), dec.eval()


def forward(enc, dec, **kw):
    """image -> the decoder's outputs."""
    return lambda image: dec(enc(image), **kw)


def main():
    rank, world, port, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    from wavelet_monodepth_tpu_torch.parallel import mesh
    assert mesh.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                       "cpu")
    mesh.warmup_collectives()
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    x = inputs["x"]
    enc, dec = build(18, inputs["enc18"], inputs["dec18"])
    m18 = mesh.make_mesh(1, world)
    band = mesh.shard_spatial(m18, x)
    out = {"band_rows": band.shape[1]}
    out["dense"] = mesh.spatial_forward(m18, forward(enc, dec))(band)
    for backend in SPARSE_BACKENDS:
        out[f"sparse_{backend}"] = mesh.spatial_forward(m18, forward(
            enc, dec, thresh_ratio=THRESH, use_pallas=backend))(band)
    m24 = mesh.make_mesh(2, world // 2)
    d = out["data_index"] = m24.data_index     # the data row's image
    x2 = torch.cat([x, x.flip(2)])[d:d + 1]
    out["mesh24"] = mesh.spatial_forward(m24, forward(enc, dec))(
        mesh.shard_spatial(m24, x2))
    enc, dec = build(50, inputs["enc50"], inputs["dec50"])
    out["r50"] = mesh.spatial_forward(m18, forward(enc, dec))(band)
    torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    mesh.shutdown()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
