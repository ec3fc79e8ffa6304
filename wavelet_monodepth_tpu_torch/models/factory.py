"""Network factory: counterpart of `wavelet_monodepth_tpu/models/factory.py`
(`KITTI/networks/network_constructors.py:12-64` and the NYU `Model`
dispatch, `NYUv2/model.py:12-71`): the ResNet (18/34/50/101/152),
MobileNetV2 and DenseNet161 encoders, the KITTI wavelet and baseline
decoders, the pose networks and the five NYU decoders.
"""

from __future__ import annotations

from .decoders_kitti import DepthDecoder, KittiWaveletDecoder
from .decoders_nyu import (NyuDecoder, NyuDecoder224, NyuDecoderWave,
                           NyuDecoderWave224)
from .densenet import NUM_CH_ENC as DENSENET_CH
from .densenet import DenseNet161Encoder
from .mobilenetv2 import MobileNetV2Encoder
from .mobilenetv2 import num_ch_enc as mobilenet_ch
from .pose import PoseCNN, PoseDecoder
from .resnet import ResnetEncoder
from .resnet import num_ch_enc as resnet_ch


def _mobilenet(encoder_type: str):
    """(encoder, num_ch_enc) for mobilenet / mobilenet_light, else None."""
    if encoder_type not in ("mobilenet", "mobilenet_light"):
        return None
    last = encoder_type == "mobilenet"
    return MobileNetV2Encoder(use_last_layer=last), mobilenet_ch(last)


def make_depth_encoder(opts):
    """(encoder module, num_ch_enc); `network_constructors.py:12-27`."""
    if opts.encoder_type == "resnet":
        return (ResnetEncoder(num_layers=opts.num_layers),
                resnet_ch(opts.num_layers))
    mobilenet = _mobilenet(opts.encoder_type)
    if mobilenet is None:
        raise NotImplementedError(opts.encoder_type)
    return mobilenet


def make_depth_decoder(num_ch_enc, opts):
    """`network_constructors.py:30-40`: the wavelet decoder (its sparse
    mode included) or the baseline DepthDecoder."""
    if opts.use_wavelets:
        return KittiWaveletDecoder(num_ch_enc=tuple(num_ch_enc))
    return DepthDecoder(num_ch_enc=tuple(num_ch_enc),
                        scales=tuple(opts.scales))


def make_posenet(opts, num_pose_frames: int, num_input_frames: int):
    """(pose encoder or None, pose decoder), `network_constructors.py:
    43-64`: "separate_resnet" is a ResNet over num_pose_frames stacked
    frames + PoseDecoder, "posecnn" a PoseCNN over 2 frames ("pairs") or
    all of them ("all"). "shared" raises: JAX's cannot run either."""
    if opts.pose_model_type == "separate_resnet":
        enc = ResnetEncoder(num_layers=opts.num_layers,
                            num_input_images=num_pose_frames)
        return enc, PoseDecoder(num_ch_enc=resnet_ch(opts.num_layers),
                                num_input_features=1,
                                num_frames_to_predict_for=2)
    if opts.pose_model_type == "posecnn":
        n = num_input_frames if opts.pose_model_input == "all" else 2
        return None, PoseCNN(num_input_frames=n)
    if opts.pose_model_type == "shared":
        raise NotImplementedError(
            "pose_model_type='shared' is not ported: the JAX package's "
            "make_posenet hands the raw frames to a PoseDecoder and its "
            "_predict_poses has no 'shared' branch, so JAX's init_state "
            "raises (ROADMAP.md, Queue 3: JAX's 'shared' pose mode)")
    raise NotImplementedError(opts.pose_model_type)


def make_nyu_encoder(opts):
    """(encoder module, num_ch_enc); `NYUv2/model.py:19-29`."""
    if opts.encoder_type == "densenet":
        return (DenseNet161Encoder(normalize_input=opts.normalize_input),
                DENSENET_CH)
    if opts.encoder_type == "resnet":
        return (ResnetEncoder(num_layers=opts.num_layers,
                              normalize_input=opts.normalize_input),
                resnet_ch(opts.num_layers))
    mobilenet = _mobilenet(opts.encoder_type)
    if mobilenet is None:
        raise NotImplementedError(opts.encoder_type)
    return mobilenet


def make_nyu_decoder(num_ch_enc, opts):
    """`NYUv2/model.py:37-64`; decoder_width fixed at 0.5, as the
    reference."""
    width = 0.5
    if opts.use_wavelets:
        if opts.use_sparse and opts.use_224:
            raise NotImplementedError(
                "sparse decoding exists at 480x640 only (NyuDecoderWave), "
                "as in the reference")
        cls = NyuDecoderWave224 if opts.use_224 else NyuDecoderWave
        return cls(num_ch_enc=tuple(num_ch_enc), decoder_width=width,
                   dw_waveconv=opts.dw_waveconv, dw_upconv=opts.dw_upconv)
    cls = NyuDecoder224 if opts.use_224 else NyuDecoder
    return cls(num_ch_enc=tuple(num_ch_enc), decoder_width=width,
               is_depthwise=(opts.dw_waveconv or opts.dw_upconv))
