"""Port parity, the serving artifact: tools/export_serving.py and
tools/serve_artifact.py of wavelet_monodepth_tpu_torch (torch.export) on
the CPU at 64x96, as tests/test_export_serving.py holds JAX's
(jax.export), and against JAX's artifacts on the same weights.

  * twins of tests/test_export_serving.py's cases: the round trip of the
    dense and sparse program against its direct forward (1e-5, the op
    count exactly), bf16 + the CLI's --verify, the NYU family, uint8
    input, export -> serve end to end, the sparse tuple output;
  * the port's artifact, exported from its own seeded weights and served
    with JAX's weights (carried across by tools/torch_import), against
    JAX's artifact on those weights: dense, sparse (total_ops equal) and
    uint8, disp within 1e-4 (the encoders differ by f32 reassociation,
    tests/test_torch_port_models.py);
  * the checkpoint swap: an artifact exported from checkpoint A serves
    checkpoint B's bundle, equal to B's direct forward (1e-5);
  * serve_artifact's .npy files against JAX's serve_artifact on the same
    PNGs (both feeds forced to PIL), 1e-4.
"""

import argparse
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from wavelet_monodepth_tpu.data import native_loader as jnl
from wavelet_monodepth_tpu.tools import export_serving as jes
from wavelet_monodepth_tpu.tools import serve_artifact as jsa
from wavelet_monodepth_tpu_torch.data import native_loader as tnl
from wavelet_monodepth_tpu_torch.tools import export_serving as es
from wavelet_monodepth_tpu_torch.tools import serve_artifact as sa
from wavelet_monodepth_tpu_torch.tools import torch_import as ti

torch.set_num_threads(1)
H, W = 64, 96
CPU = torch.device("cpu")


def _args(tmp_path, name="art", **kw):
    base = dict(out=str(tmp_path / name), model_path=None,
                torch_model_path=None, num_layers=18, height=H, width=W,
                batch=1, use_sparse=False, threshold=0.1, bfloat16=False,
                verify=False, family="kitti", encoder_type="densenet",
                uint8_input=False, bundle_params=False)
    base.update(kw)
    return argparse.Namespace(**base)


def _image(seed, batch=1, u8=False):
    gen = torch.Generator().manual_seed(seed)
    if u8:
        return torch.randint(0, 256, (batch, H, W, 3), generator=gen,
                             dtype=torch.uint8)
    return torch.rand((batch, H, W, 3), generator=gen)


def _run(program, img):
    with torch.inference_mode():
        return program(img)


# ---------------------------------------------------------------------------
# twins of tests/test_export_serving.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sparse", [False, True])
def test_export_roundtrip_matches_direct(tmp_path, sparse):
    args = _args(tmp_path, use_sparse=sparse)
    _, program = es.export_artifact(args, CPU)
    with open(args.out + ".json") as f:
        meta = json.load(f)
    assert meta["height"] == H and meta["dtype"] == "float32"
    assert meta["sparse_threshold"] == (0.1 if sparse else None)
    assert meta["platforms"] == ["cpu", "cpu"]
    assert meta["outputs"] == (["disp_0", "total_ops"] if sparse
                               else ["disp_0"])

    rebuilt, _ = sa.load_program(args.out, CPU, program.state_dict())
    img = _image(3)
    direct, via = _run(program, img), _run(rebuilt, img)
    if sparse:
        torch.testing.assert_close(via[0], direct[0], atol=1e-5, rtol=0)
        torch.testing.assert_close(via[1], direct[1], atol=0, rtol=0)
        assert via[1].shape == (1,) and bool((via[1] > 0).all())
    else:
        assert via.shape == (1, H, W, 1) and via.dtype == torch.float32
        torch.testing.assert_close(via, direct, atol=1e-5, rtol=0)


def test_export_bf16_and_cli_verify(tmp_path, capsys):
    out = str(tmp_path / "art")
    es.main(["--out", out, "--height", str(H), "--width", str(W),
             "--bfloat16", "--verify", "--device", "cpu"])
    assert os.path.exists(out + ".pt2")
    assert "verified: artifact runs" in capsys.readouterr().out
    with open(out + ".json") as f:
        assert json.load(f)["dtype"] == "bfloat16"


def test_export_nyu_family(tmp_path):
    args = _args(tmp_path, use_sparse=True, family="nyu",
                 encoder_type="mobilenet_light")
    _, program = es.export_artifact(args, CPU)
    with open(args.out + ".json") as f:
        assert json.load(f)["model"] == "nyu_mobilenet_light_wavelet"
    rebuilt, _ = sa.load_program(args.out, CPU, program.state_dict())
    img = _image(5)
    direct, via = _run(program, img), _run(rebuilt, img)
    torch.testing.assert_close(via[0], direct[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(via[1], direct[1], atol=0, rtol=0)


def test_export_uint8_input(tmp_path):
    """A --uint8_input artifact takes uint8 images and matches the f32
    program fed the same pixels / 255."""
    args = _args(tmp_path, uint8_input=True)
    _, program = es.export_artifact(args, CPU)
    with open(args.out + ".json") as f:
        assert json.load(f)["input_dtype"] == "uint8"
    rebuilt, _ = sa.load_program(args.out, CPU, program.state_dict())
    img = _image(5, u8=True)
    via = _run(rebuilt, img)
    f32 = es.build(_args(tmp_path), CPU)
    direct = _run(f32, img.to(torch.float32) / 255.0)
    torch.testing.assert_close(via, direct, atol=1e-5, rtol=0)
    es.verify_artifact(args.out, program.state_dict(), args, CPU)


def _write_pngs(folder, n, seed, shape=(H, W)):
    folder.mkdir()
    rng = np.random.RandomState(seed)
    arrs = []
    for i in range(n):
        a = rng.randint(0, 255, shape + (3,), np.uint8)
        arrs.append(a)
        Image.fromarray(a).save(folder / f"im_{i}.png")
    return arrs


def test_serve_artifact_end_to_end(tmp_path, capsys):
    """export --bundle_params -> serve_artifact runs the program with no
    model-building Python and writes <stem>_disp.npy matching the direct
    forward, over a padded tail batch."""
    args = _args(tmp_path, uint8_input=True, bundle_params=True, batch=2)
    _, program = es.export_artifact(args, CPU)
    assert os.path.exists(args.out + ".params.pt")
    arrs = _write_pngs(tmp_path / "imgs", 3, 0)
    out_dir = tmp_path / "preds"
    res = sa.main(["--artifact", args.out, "--images",
                   str(tmp_path / "imgs"), "--out", str(out_dir),
                   "--device", "cpu"])
    assert res["served"] == 3 and res["feed"] in ("native", "pil")
    assert f"({res['feed']} feed)" in capsys.readouterr().out
    for i, a in enumerate(arrs):
        got = np.load(out_dir / f"im_{i}_disp.npy")
        want = _run(program, torch.from_numpy(a[None]))[0, :, :, 0]
        np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=0)


def test_serve_artifact_sparse_tuple_output(tmp_path):
    """A sparse artifact returns (disp, total_ops); the runner takes the
    disp element."""
    args = _args(tmp_path, use_sparse=True, uint8_input=True,
                 bundle_params=True)
    es.export_artifact(args, CPU)
    _write_pngs(tmp_path / "imgs", 1, 1)
    out_dir = tmp_path / "preds"
    sa.main(["--artifact", args.out, "--images",
             str(tmp_path / "imgs" / "im_0.png"), "--out", str(out_dir),
             "--device", "cpu"])
    disp = np.load(out_dir / "im_0_disp.npy")
    assert disp.shape == (H, W) and np.isfinite(disp).all()


@pytest.fixture(scope="module")
def plain_artifact(tmp_path_factory):
    """A dense f32 artifact exported without its bundle."""
    args = _args(tmp_path_factory.mktemp("plain"))
    es.export_artifact(args, CPU)
    return args.out


def test_artifact_runs_on_its_export_device_only(plain_artifact):
    with pytest.raises(ValueError, match="exported on cpu"):
        sa.load_program(plain_artifact, "cuda", {})


def test_serve_without_bundle_names_the_flag(plain_artifact):
    with pytest.raises(FileNotFoundError, match="--bundle_params"):
        sa.load_program(plain_artifact, CPU)


def test_bundle_of_another_architecture_is_refused(plain_artifact,
                                                    tmp_path):
    r34 = es.build(_args(tmp_path, num_layers=34), CPU)
    with pytest.raises(RuntimeError, match="state_dict"):
        sa.load_program(plain_artifact, CPU, r34.state_dict())


# ---------------------------------------------------------------------------
# the checkpoint swap
# ---------------------------------------------------------------------------

def _seeded_folder(path, seed):
    from wavelet_monodepth_tpu_torch.models.decoders_kitti import \
        KittiWaveletDecoder
    from wavelet_monodepth_tpu_torch.models.layers import init_params
    from wavelet_monodepth_tpu_torch.models.resnet import ResnetEncoder
    gen = torch.Generator().manual_seed(seed)
    enc = init_params(ResnetEncoder(18), gen)
    dec = init_params(KittiWaveletDecoder(enc.num_ch_enc), gen)
    ti.save_reference_checkpoint(str(path), enc, dec, H, W)
    return str(path)


@pytest.mark.parametrize("sparse", [False, True])
def test_checkpoint_swap(tmp_path, sparse):
    """Exported from checkpoint A (--model_path), the artifact serves B's
    bundle: equal to B's direct forward, not to A's."""
    folder_a = _seeded_folder(tmp_path / "a", 1)
    folder_b = _seeded_folder(tmp_path / "b", 2)
    args = _args(tmp_path, model_path=folder_a, use_sparse=sparse,
                 bundle_params=True)
    _, program_a = es.export_artifact(args, CPU)
    program_b = es.build(_args(tmp_path, model_path=folder_b,
                               use_sparse=sparse), CPU)
    torch.save(program_b.state_dict(), args.out + ".params.pt")
    served, _ = sa.load_program(args.out, CPU)
    img = _image(7)
    via, want_b, was_a = (_run(served, img), _run(program_b, img),
                          _run(program_a, img))
    pick = (lambda o: o[0]) if sparse else (lambda o: o)
    torch.testing.assert_close(pick(via), pick(want_b), atol=1e-5, rtol=0)
    assert float((pick(via) - pick(was_a)).abs().max()) > 1e-3
    if sparse:
        torch.testing.assert_close(via[1], want_b[1], atol=0, rtol=0)


# ---------------------------------------------------------------------------
# against JAX's artifacts on the same weights
# ---------------------------------------------------------------------------

def _bundle_from_jax(enc_vars, dec_vars) -> dict:
    """JAX variables -> the port program's state dict (`encoder.*`,
    `depth.*`), through the port's importer (BN's num_batches_tracked,
    which JAX has no value for, filled as it fills it)."""
    np_tree = jax.tree_util.tree_map(np.asarray, (enc_vars, dec_vars))
    program = es.build(_args(pathlib.Path(".")), CPU)
    ti.load_state_dicts(program.encoder, program.depth,
                        *ti.state_dicts_from_jax(*np_tree))
    return program.state_dict()


@pytest.fixture(scope="module")
def jax_artifacts(tmp_path_factory):
    """{mode: (JAX's rebuilt program, JAX's variables, the port's
    artifact prefix, the port bundle of JAX's variables)}, dense, sparse
    and uint8; the uint8 one with JAX's bundle too (for serve)."""
    root = tmp_path_factory.mktemp("jax_vs_port")
    out = {}
    for mode, kw in (("dense", {}), ("sparse", {"use_sparse": True}),
                     ("uint8", {"uint8_input": True,
                                "bundle_params": True})):
        jargs = _args(root, f"jax_{mode}", **kw)
        _, enc_vars, dec_vars = jes.export_artifact(jargs)
        with open(jargs.out + ".stablehlo", "rb") as f:
            rebuilt = jax.export.deserialize(f.read())
        targs = _args(root, f"port_{mode}", **kw)
        es.export_artifact(targs, CPU)
        bundle = _bundle_from_jax(enc_vars, dec_vars)
        out[mode] = (rebuilt, (enc_vars, dec_vars), targs.out, bundle,
                     jargs.out)
    return out


@pytest.mark.parametrize("mode", ["dense", "sparse", "uint8"])
def test_port_artifact_equals_jax_artifact(jax_artifacts, mode):
    rebuilt, (enc_vars, dec_vars), prefix, bundle, _ = jax_artifacts[mode]
    program, _ = sa.load_program(prefix, CPU, bundle)
    img = _image(11, batch=1, u8=mode == "uint8")
    ours = _run(program, img)
    theirs = rebuilt.call(enc_vars, dec_vars, jnp.asarray(img.numpy()))
    if mode == "sparse":
        np.testing.assert_allclose(ours[0].numpy(), np.asarray(theirs[0]),
                                   atol=1e-4, rtol=0)
        np.testing.assert_array_equal(ours[1].numpy(),
                                      np.asarray(theirs[1]).reshape(-1))
    else:
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   atol=1e-4, rtol=0)


def test_serve_artifact_equals_jax_serve(jax_artifacts, tmp_path,
                                         monkeypatch):
    """Both runners over the same PNGs (larger than the feed, so the
    LANCZOS resize runs), both feeds forced to PIL: the .npy files agree
    within 1e-4."""
    monkeypatch.setattr(jnl, "available", lambda: False)
    monkeypatch.setattr(tnl, "available", lambda: False)
    _, _, prefix, bundle, jprefix = jax_artifacts["uint8"]
    torch.save(bundle, prefix + ".params.pt")
    _write_pngs(tmp_path / "imgs", 3, 2, shape=(100, 150))
    jsa.main(["--artifact", jprefix, "--images", str(tmp_path / "imgs"),
              "--out", str(tmp_path / "jax")])
    res = sa.main(["--artifact", prefix, "--images",
                   str(tmp_path / "imgs"), "--out", str(tmp_path / "port"),
                   "--device", "cpu"])
    assert res["feed"] == "pil"
    for i in range(3):
        ours = np.load(tmp_path / "port" / f"im_{i}_disp.npy")
        theirs = np.load(tmp_path / "jax" / f"im_{i}_disp.npy")
        assert ours.shape == theirs.shape == (H, W)
        np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=0)
