"""Port parity, the pose and baseline models and their tools: the
two-image ResNet18 pose encoder, PoseDecoder, PoseCNN and the baseline
DepthDecoder of wavelet_monodepth_tpu_torch against the JAX modules
(weights crossed by tools/torch_import.py), the bridge's key sets and the
reference-layout round trip, the pose-frame warps and losses
(separate_resnet, PoseCNN pairs and all), eval/pose_eval.py,
tools/evaluate_pose.main on a mini odometry tree and
tools/precompute_depth_hints on a 256x64 pair, at 64x96 where not said.

Tolerances, each with its reason:
  * the pose encoder's features 1e-4, as tests/test_torch_port_models.py
    holds the depth encoder's: in eval mode JAX folds the input
    normalisation into the stem BN and the port does not; in train mode
    the batch statistics are summed in another order (up to 1.8e-5 at
    layer1 on this input); equal up to float32 reassociation;
  * the pose heads, PoseCNN and the baseline decoder 1e-5 on the same
    inputs;
  * the warps' losses 1e-5 relative; warped images 1e-5 at scale 0 and
    1e-4 at the others (the x2-x8 bilinear upsampling of disp rounds
    differently in jax.image.resize and F.interpolate, as
    tests/test_torch_port_losses.py);
  * the trajectory functions bit for bit (the same float64 numpy);
    predicted transforms 1e-5 (float32 networks), the ATE 1e-5;
  * the hint files equal, except at pixels where the two best
    candidates' reprojection losses lie within 1e-5 (float32 sums in
    another order can swap them).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from wavelet_monodepth_tpu.eval import pose_eval as jpe
from wavelet_monodepth_tpu.models.decoders_kitti import \
    DepthDecoder as JDepthDecoder
from wavelet_monodepth_tpu.models.pose import PoseCNN as JPoseCNN
from wavelet_monodepth_tpu.models.pose import PoseDecoder as JPoseDecoder
from wavelet_monodepth_tpu.models.resnet import ResnetEncoder as JEncoder
from wavelet_monodepth_tpu.models.resnet import num_ch_enc as j_num_ch_enc
from wavelet_monodepth_tpu.ops import geometry as jgeo
from wavelet_monodepth_tpu.tools import evaluate_pose as jevp
from wavelet_monodepth_tpu.tools import precompute_depth_hints as jhints
from wavelet_monodepth_tpu.tools import torch_import as jti
from wavelet_monodepth_tpu.train import losses_kitti as jl
from wavelet_monodepth_tpu.utils import checkpoint as jckpt
from wavelet_monodepth_tpu.utils.config import KittiOptions as JOptions
from wavelet_monodepth_tpu_torch.eval import pose_eval as tpe
from wavelet_monodepth_tpu_torch.models.decoders_kitti import DepthDecoder
from wavelet_monodepth_tpu_torch.models.pose import PoseCNN, PoseDecoder
from wavelet_monodepth_tpu_torch.models.resnet import ResnetEncoder
from wavelet_monodepth_tpu_torch.ops import geometry as tgeo
from wavelet_monodepth_tpu_torch.tools import evaluate_pose as tevp
from wavelet_monodepth_tpu_torch.tools import precompute_depth_hints as thints
from wavelet_monodepth_tpu_torch.tools import torch_import as ti
from wavelet_monodepth_tpu_torch.train import losses_kitti as tl
from wavelet_monodepth_tpu_torch.utils.config import KittiOptions as TOptions

torch.set_num_threads(1)
H, W, N = 64, 96, 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda v: np.array(v), tree)


def _perturb_bn(variables, seed=0):
    """Non-trivial BN affine and running statistics, so the bridge of every
    BN field is exercised."""
    rng = np.random.RandomState(seed)
    v = _np_tree(variables)

    def walk(p, s):
        for k in p:
            if k == "bn":
                c = p[k]["scale"].shape[0]
                p[k]["scale"] = (1 + 0.1 * rng.randn(c)).astype(np.float32)
                p[k]["bias"] = (0.1 * rng.randn(c)).astype(np.float32)
                s[k]["mean"] = (0.1 * rng.randn(c)).astype(np.float32)
                s[k]["var"] = (1 + 0.2 * rng.rand(c)).astype(np.float32)
            elif isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])
    walk(v["params"], v["batch_stats"])
    return v


@pytest.fixture(scope="module")
def nets():
    """JAX's two-image pose encoder (perturbed BN), PoseDecoder, PoseCNN
    (2 and 3 frames) and baseline decoder, with their variables."""
    key = jax.random.PRNGKey(0)
    px = jnp.zeros((1, H, W, 6), jnp.float32)
    penc = JEncoder(num_layers=18, num_input_images=2)
    pev = _perturb_bn(penc.init(key, px))
    pdec = JPoseDecoder(num_ch_enc=j_num_ch_enc(18), num_input_features=1,
                        num_frames_to_predict_for=2)
    pdv = _np_tree(pdec.init(key, [penc.apply(pev, px)]))
    cnn2, cnn3 = JPoseCNN(num_input_frames=2), JPoseCNN(num_input_frames=3)
    cv2_ = _np_tree(cnn2.init(key, px))
    cv3 = _np_tree(cnn3.init(key, jnp.zeros((1, H, W, 9), jnp.float32)))
    feats = [jnp.zeros((1, H // 2 ** (i + 1), W // 2 ** (i + 1), c))
             for i, c in enumerate(j_num_ch_enc(18))]
    bdec = JDepthDecoder(num_ch_enc=j_num_ch_enc(18))
    bdv = _np_tree(bdec.init(key, feats))
    return dict(penc=penc, pev=pev, pdec=pdec, pdv=pdv, cnn2=cnn2, cv2=cv2_,
                cnn3=cnn3, cv3=cv3, bdec=bdec, bdv=bdv)


def _port_pose_pair(nets):
    """The port's pose encoder and PoseDecoder on JAX's weights."""
    enc = ResnetEncoder(18, num_input_images=2)
    dec = PoseDecoder(j_num_ch_enc(18))
    ti.load_state_dicts(enc, dec,
                        ti.state_dicts_from_jax(nets["pev"], None)[0],
                        ti.pose_state_dict_from_jax(nets["pdv"]))
    return enc, dec


def _port_pose(variables, module):
    module.load_state_dict(ti.pose_state_dict_from_jax(variables),
                           strict=True)
    return module


# --- forwards ----------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_pose_encoder_matches_jax(nets, train):
    x = np.random.RandomState(1).rand(N, H, W, 6).astype(np.float32)
    if train:
        ref, _ = nets["penc"].apply(nets["pev"], jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
    else:
        ref = nets["penc"].apply(nets["pev"], jnp.asarray(x))
    enc = _port_pose_pair(nets)[0].train(train)
    with torch.no_grad():
        ours = enc(_t(x))
    for i, (a, b) in enumerate(zip(ours, ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4,
                                   err_msg=f"feat{i}")
    with pytest.raises(ValueError, match="expects 6 input channels"):
        enc(_t(x[..., :3]))


def test_pose_decoder_matches_jax(nets):
    rs = np.random.RandomState(2)
    feats = [rs.rand(N, H // 2 ** (i + 1), W // 2 ** (i + 1), c)
             .astype(np.float32) for i, c in enumerate(j_num_ch_enc(18))]
    ref = nets["pdec"].apply(nets["pdv"], [[jnp.asarray(f) for f in feats]])
    dec = _port_pose_pair(nets)[1]
    with torch.no_grad():
        ours = dec([[_t(f) for f in feats]])
    for a, b in zip(ours, ref):
        assert a.shape == b.shape == (N, 2, 1, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("frames", [2, 3])
def test_pose_cnn_matches_jax(nets, frames):
    x = np.random.RandomState(3).rand(N, H, W, 3 * frames).astype(np.float32)
    ref = nets[f"cnn{frames}"].apply(nets[f"cv{frames}"], jnp.asarray(x))
    cnn = _port_pose(nets[f"cv{frames}"], PoseCNN(frames))
    with torch.no_grad():
        ours = cnn(_t(x))
    for a, b in zip(ours, ref):
        assert a.shape == b.shape == (N, frames - 1, 1, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


def test_baseline_decoder_matches_jax(nets):
    rs = np.random.RandomState(4)
    feats = [rs.rand(N, H // 2 ** (i + 1), W // 2 ** (i + 1), c)
             .astype(np.float32) for i, c in enumerate(j_num_ch_enc(18))]
    ref = nets["bdec"].apply(nets["bdv"], [jnp.asarray(f) for f in feats])
    dec = DepthDecoder(j_num_ch_enc(18))
    dec.load_state_dict(ti.state_dicts_from_jax(None, nets["bdv"])[1],
                        strict=True)
    with torch.no_grad():
        ours = dec([_t(f) for f in feats])
    assert set(ours) == set(ref) == {("disp", s) for s in range(4)}
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-5, err_msg=str(k))
    with pytest.raises(NotImplementedError, match="use_polyphase"):
        DepthDecoder(j_num_ch_enc(18), use_polyphase=True)


# --- the bridge --------------------------------------------------------------

def _keys(sd, drop=".num_batches_tracked"):
    return {k for k in sd if not k.endswith(drop)}


def test_bridge_key_sets_equal_jax_exporters(nets):
    """For the four new modules the port's bridge writes, key for key and
    value for value, what JAX's exporters write, and those are the port
    modules' own state-dict keys."""
    cases = [
        (ti.state_dicts_from_jax(nets["pev"], None)[0],
         jti.export_resnet_encoder(nets["pev"]),
         ResnetEncoder(18, num_input_images=2)),
        (ti.pose_state_dict_from_jax(nets["pdv"]),
         jti.export_pose_decoder(nets["pdv"]), PoseDecoder(j_num_ch_enc(18))),
        (ti.pose_state_dict_from_jax(nets["cv3"]),
         jti.export_pose_cnn(nets["cv3"]), PoseCNN(3)),
        (ti.state_dicts_from_jax(None, nets["bdv"])[1],
         jti.export_kitti_baseline_decoder(nets["bdv"]),
         DepthDecoder(j_num_ch_enc(18)))]
    for ours, ref, module in cases:
        assert set(ours) == set(ref) == _keys(module.state_dict())
        for k in ref:
            assert np.array_equal(ours[k].numpy(), np.asarray(ref[k])), k


def test_reference_layout_round_trip(nets, tmp_path):
    """save_pose_checkpoint writes the reference's pose_encoder.pth (under
    `encoder.`) and pose.pth; load_pose_checkpoint reads them back, and the
    JAX exporter's unscoped pose_encoder.pth too, into fresh modules with
    strict=True."""
    enc, dec = _port_pose_pair(nets)
    ti.save_pose_checkpoint(str(tmp_path), enc, dec)
    jax_folder = tmp_path / "jax"
    jax_folder.mkdir()
    torch.save({k: _t(v) for k, v in jti.export_resnet_encoder(
        nets["pev"], prefix="").items()}, jax_folder / "pose_encoder.pth")
    torch.save({k: _t(v) for k, v in jti.export_pose_decoder(
        nets["pdv"]).items()}, jax_folder / "pose.pth")
    for folder in (tmp_path, jax_folder):
        enc_sd, pose_sd = ti.load_pose_checkpoint(str(folder))
        assert all(k.startswith("encoder.") for k in enc_sd)
        e2 = ResnetEncoder(18, num_input_images=2)
        d2 = PoseDecoder(j_num_ch_enc(18))
        ti.load_state_dicts(e2, d2, enc_sd, pose_sd)
        for a, b in ((enc, e2), (dec, d2)):
            sa, sb = a.state_dict(), b.state_dict()
            assert set(sa) == set(sb)
            for k in sa:
                if not k.endswith("num_batches_tracked"):
                    assert torch.equal(sa[k], sb[k]), k


def test_multiimage_imagenet_equals_jax():
    rs = np.random.RandomState(5)
    sd = {"conv1.weight": rs.randn(64, 3, 7, 7).astype(np.float32)}
    ours = ti.multiimage_imagenet({k: _t(v) for k, v in sd.items()}, 3)
    ref = np.concatenate([sd["conv1.weight"]] * 3, axis=1) / 3
    assert ours["conv1.weight"].shape == (64, 9, 7, 7)
    np.testing.assert_array_equal(ours["conv1.weight"].numpy(), ref)


# --- the pose-frame warps and losses -----------------------------------------

def _scene(seed=0):
    """Frames 0, -1, 1 and s at every scale (textures smoothed as
    camera images are, so a float32 rounding of a sample position moves
    the sampled colour by less than it), intrinsics, a stereo pose, hints
    with holes, and disparities per scale."""
    rs = np.random.RandomState(seed)
    inputs = {}
    for s in range(4):
        h, w = H // 2 ** s, W // 2 ** s
        for fid in ("0", "-1", "1", "s"):
            tex = rs.rand(N, h, w, 3)
            for _ in range(2):
                tex = (tex + np.roll(tex, 1, 1) + np.roll(tex, 1, 2)) / 3.0
            inputs[("color", fid, s)] = tex.astype(np.float32)
        k = np.eye(4, dtype=np.float32)
        k[0, 0], k[1, 1], k[0, 2], k[1, 2] = 0.58 * w, 1.92 * h, w / 2, h / 2
        inputs[("K", s)] = np.repeat(k[None], N, 0)
        inputs[("inv_K", s)] = np.linalg.pinv(inputs[("K", s)]).astype(
            np.float32)
    t = np.repeat(np.eye(4, dtype=np.float32)[None], N, 0)
    t[:, 0, 3] = (0.1, -0.1)
    inputs[("stereo_T",)] = t
    depth = (rs.rand(N, H, W, 1) * 20 + 2).astype(np.float32)
    depth[:, ::7, ::5] = 0.0
    # no hints in the 8 border columns: there the predicted-depth warp and
    # the hint warp both clamp to the same border pixel, reproj and
    # hint-reproj tie exactly, and the argmin would follow float rounding
    # (as tests/test_torch_port_train.py's batch)
    depth[:, :, :8] = 0.0
    depth[:, :, -8:] = 0.0
    inputs[("depth_hint",)] = depth
    inputs[("depth_hint_mask",)] = (depth > 0).astype(np.float32)
    outputs = {("disp", s): rs.uniform(0.02, 0.3, (N, H // 2 ** s,
                                                   W // 2 ** s, 1))
               .astype(np.float32) for s in range(4)}
    # pose-net outputs: axisangle / translation (N, frames, 1, 3)
    aa = (0.02 * rs.randn(N, 2, 1, 3)).astype(np.float32)
    tr = (0.3 * rs.randn(N, 2, 1, 3)).astype(np.float32)
    return inputs, outputs, aa, tr


def _pose_T(geo, aa, tr, mode, asarray):
    """The trainers' pose outputs from (aa, tr) in "pairs" (one pass per
    frame: here frame -1 takes [:, :1], frame 1 [:, 1:], each read at
    [:, 0]) or "all" (both from one pass, frame idx at [:, idx])."""
    out = {}
    for idx, f_i in enumerate((-1, 1)):
        if mode == "pairs":
            a, t = asarray(aa[:, idx:idx + 1]), asarray(tr[:, idx:idx + 1])
            cam = geo.transformation_from_parameters(a[:, 0], t[:, 0],
                                                     invert=f_i < 0)
        else:
            a, t = asarray(aa), asarray(tr)
            cam = geo.transformation_from_parameters(a[:, idx], t[:, idx])
        out[("axisangle", 0, f_i)] = a
        out[("translation", 0, f_i)] = t
        out[("cam_T_cam", 0, f_i)] = cam
    return out


@pytest.mark.parametrize("case", [
    dict(pose_model_type="separate_resnet", use_stereo=True,
         use_depth_hints=True),
    dict(pose_model_type="separate_resnet", use_stereo=False),
    dict(pose_model_type="posecnn", pose_model_input="pairs"),
    dict(pose_model_type="posecnn", pose_model_input="all",
         use_stereo=True)])
def test_pose_frame_warps_and_losses_match_jax(case):
    fields = dict(frame_ids=(0, -1, 1), use_wavelets=True, height=H,
                  width=W, batch_size=N, **case)
    jo, to = JOptions(**fields), TOptions(**fields)
    inputs, outputs, aa, tr = _scene()
    mode = case.get("pose_model_input", "pairs")
    hints = case.get("use_depth_hints", False)
    jfn = jl.compute_losses_hints if hints else jl.compute_losses_mdp
    tfn = tl.compute_losses_hints if hints else tl.compute_losses_mdp
    rng = jax.random.PRNGKey(3)

    @jax.jit
    def ref_fn(ins, outs, r):
        pose_T = _pose_T(jgeo, aa, tr, mode, jnp.asarray)
        outs = jl.generate_images_pred(ins, {**outs, **pose_T}, jo, pose_T)
        return jfn(ins, outs, jo, r), outs

    ref, ref_out = ref_fn({k: jnp.asarray(v) for k, v in inputs.items()},
                          {k: jnp.asarray(v) for k, v in outputs.items()},
                          rng)
    tin = {k: _t(v) for k, v in inputs.items()}
    pose_T = _pose_T(tgeo, aa, tr, mode, _t)
    tout = tl.generate_images_pred(
        tin, {**{k: _t(v) for k, v in outputs.items()}, **pose_T}, to,
        pose_T)
    noise = {}
    for s in range(4):
        rng, sub = jax.random.split(rng)
        noise[s] = _t(jax.random.normal(sub, (N, H, W, 1), jnp.float32))
    ours = tfn(tin, tout, to, noise)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
    for fid in [f for f in jo.all_frame_ids[1:]]:
        for s in range(4):
            k = ("color", str(fid), s)
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(ref_out[k]),
                                       rtol=0, atol=1e-5 if s == 0 else 1e-4,
                                       err_msg=str(k))
    if "s" in jo.all_frame_ids and hints:
        np.testing.assert_allclose(
            tout[("color_depth_hint", "s", 0)].numpy(),
            np.asarray(ref_out[("color_depth_hint", "s", 0)]), rtol=0,
            atol=1e-5)


# --- odometry evaluation -----------------------------------------------------

N_FRAMES = 8


def write_mini_odom(root) -> str:
    """tests/test_cli_e2e_pose.py's tree under the pathlib.Path `root`:
    sequence 09 PNGs (64x192), a forward trajectory with a slow yaw in
    poses/09.txt, the split."""
    rng = np.random.RandomState(2)
    img_dir = root / "sequences" / "09" / "image_2"
    img_dir.mkdir(parents=True)
    for f in range(N_FRAMES):
        arr = rng.randint(0, 255, (64, 192, 3), dtype=np.uint8)
        Image.fromarray(arr).save(img_dir / f"{f:06d}.png")
    (root / "poses").mkdir()
    rows = []
    for i in range(N_FRAMES):
        th = 0.02 * i
        t = np.array([[np.cos(th), 0, np.sin(th), 0.1 * i],
                      [0, 1, 0, 0.01 * i],
                      [-np.sin(th), 0, np.cos(th), 0.5 * i]])
        rows.append(" ".join(f"{v:.9e}" for v in t.reshape(-1)))
    (root / "poses" / "09.txt").write_text("\n".join(rows) + "\n")
    splits = root / "splits" / "odom"
    splits.mkdir(parents=True)
    (splits / "test_files_09.txt").write_text(
        "".join(f"9 {f} l\n" for f in range(N_FRAMES - 1)))
    return str(root)


@pytest.fixture(scope="module")
def mini_odom(tmp_path_factory):
    return write_mini_odom(tmp_path_factory.mktemp("kitti_odom"))


def test_trajectory_functions_bit_equal_jax():
    rs = np.random.RandomState(6)
    gt = np.concatenate([np.linalg.qr(rs.randn(9, 3, 3))[0],
                         rs.randn(9, 3, 1)], axis=2)
    rel = [np.vstack([np.hstack([np.linalg.qr(rs.randn(3, 3))[0],
                                 rs.randn(3, 1)]), [[0, 0, 0, 1]]])
           for _ in range(8)]
    for a, b in zip(tpe.dump_xyz(rel), jpe.dump_xyz(rel)):
        assert np.array_equal(a, b)
    xa, xb = rs.randn(5, 3), rs.randn(5, 3)
    assert tpe.compute_ate(xa, xb) == jpe.compute_ate(xa, xb)
    for a, b in zip(tpe.local_gt_poses(gt), jpe.local_gt_poses(gt)):
        assert np.array_equal(a, b)
    preds = np.stack(rel).astype(np.float32)
    assert tpe.evaluate_trajectory(preds, gt) == \
        jpe.evaluate_trajectory(preds, gt)


def test_predict_poses_matches_jax(nets):
    rs = np.random.RandomState(7)
    pairs = [rs.rand(H, W, 6).astype(np.float32),
             rs.rand(2, H, W, 6).astype(np.float32)]

    def jforward(pair):
        return nets["pdec"].apply(nets["pdv"],
                                  [nets["penc"].apply(nets["pev"], pair)])
    ref = jpe.predict_poses(jax.jit(jforward), pairs)
    enc, dec = _port_pose_pair(nets)
    enc.eval()
    ours = tpe.predict_poses(lambda x: dec([enc(x)]), pairs, "cpu")
    assert ours.shape == ref.shape == (3, 4, 4) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_evaluate_pose_main_matches_jax(nets, mini_odom, tmp_path):
    """JAX's evaluate_pose on its own checkpoint (--load_weights_folder,
    which writes poses.npy) against the port's on the same weights crossed
    into the reference layout (--torch_model_path) and in the port's
    checkpoint folder (--load_weights_folder, poses.npy again)."""
    base = ["--data_path", mini_odom, "--eval_split", "odom_9",
            "--height", "64", "--width", "128",
            "--splits_dir", os.path.join(mini_odom, "splits")]
    # JAX's variables at this feed size (the PoseDecoder's are size-free;
    # the ResNet's too), perturbed BN included
    state = {"params": {"pose_encoder": nets["pev"]["params"],
                        "pose": nets["pdv"]["params"]},
             "batch_stats": {"pose_encoder": nets["pev"]["batch_stats"]}}
    jfolder = jckpt.save_checkpoint(str(tmp_path / "jax"), 0, state)
    jevp.main(base + ["--load_weights_folder", jfolder])
    jposes = np.load(os.path.join(jfolder, "poses.npy"))
    gt = np.loadtxt(os.path.join(mini_odom, "poses", "09.txt")).reshape(
        -1, 3, 4)
    jate = jpe.evaluate_trajectory(jposes, gt)

    ref_folder = str(tmp_path / "reference")
    ti.save_pose_checkpoint(ref_folder, *_port_pose_pair(nets))
    ours = tevp.main(base + ["--torch_model_path", ref_folder,
                             "--device", "cpu"])
    np.testing.assert_allclose(ours["poses"], jposes, rtol=0, atol=1e-5)
    np.testing.assert_allclose([ours["ate_mean"], ours["ate_std"]], jate,
                               rtol=0, atol=1e-5)
    assert np.isfinite(ours["ate_mean"]) and ours["ate_mean"] > 0
    again = tevp.main(base + ["--load_weights_folder", ref_folder,
                              "--device", "cpu"])
    assert again["ate_mean"] == ours["ate_mean"]
    assert np.array_equal(np.load(os.path.join(ref_folder, "poses.npy")),
                          again["poses"])
    if not torch.cuda.is_available():     # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tevp.main(base)


# --- depth-hint precompute ---------------------------------------------------

HINT_H, HINT_W = 64, 256
FOLDER = "2011_09_26/2011_09_26_drive_0001_sync"


@pytest.fixture(scope="module")
def hint_mount(tmp_path_factory):
    """One textured stereo pair at 256x64 (the right view shifted by 6-12
    px), written as JPEGs in the raw layout, and a file list of both
    sides."""
    root = tmp_path_factory.mktemp("hints")
    rs = np.random.RandomState(8)
    tex = rs.rand(HINT_H, HINT_W + 16, 3)
    for _ in range(2):
        tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)) / 3.0
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    left = tex[:, 16:16 + HINT_W]
    shift = 6 + (np.arange(HINT_H) * 6 // HINT_H)
    right = np.stack([tex[y, 16 - shift[y]:16 - shift[y] + HINT_W]
                      for y in range(HINT_H)])
    for side, img in (("02", left), ("03", right)):
        d = root / FOLDER / f"image_{side}" / "data"
        d.mkdir(parents=True)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            d / "0000000000.jpg", quality=95)
    files = root / "files.txt"
    files.write_text(f"{FOLDER} 0 l\n{FOLDER} 0 r\n")
    return str(root), str(files)


def test_precompute_depth_hints_equals_jax(hint_mount, tmp_path):
    root, files = hint_mount
    argv = ["--data_path", root, "--filenames", files, "--height",
            str(HINT_H), "--width", str(HINT_W), "--num_workers", "1"]
    jhints.main(argv + ["--save_path", str(tmp_path / "jax")])
    assert thints.main(argv + ["--save_path", str(tmp_path / "port"),
                               "--device", "cpu"]) == 2
    import cv2
    for side, folder, other in (("l", "image_02", "image_03"),
                                ("r", "image_03", "image_02")):
        ref = np.load(tmp_path / "jax" / FOLDER / folder / "0000000000.npy")
        ours = np.load(tmp_path / "port" / FOLDER / folder /
                       "0000000000.npy")
        assert ours.shape == ref.shape == (1, HINT_H, HINT_W)
        assert ours.dtype == np.float32
        # the pixels where rounding may pick another candidate: the two
        # least losses within 1e-5
        views = [cv2.resize(cv2.cvtColor(cv2.imread(os.path.join(
            root, FOLDER, f, "data", "0000000000.jpg")), cv2.COLOR_BGR2RGB),
            (HINT_W, HINT_H)) for f in (folder, other)]
        depths = thints.compute_depths(thints.generate_stereo_matchers(),
                                       *views, HINT_W, reverse=side == "r")
        losses = thints.fusion_losses(_t(depths), _t(views[0]),
                                      _t(views[1]),
                                      -1 if side == "l" else 1).numpy()
        two = np.sort(losses, axis=0)[:2]
        tie = (two[1] - two[0]) <= 1e-5
        differ = ours[0] != ref[0]
        assert not (differ & ~tie).any(), (differ & ~tie).sum()
        # not vacuous: SGBM matched a fair share of the pixels
        assert (ours[0] > 0).mean() > 0.2
