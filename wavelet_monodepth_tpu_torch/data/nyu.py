"""NYUv2 host-side input pipeline (NHWC numpy).

Counterpart of `wavelet_monodepth_tpu/data/nyu.py` (the reference's
`NYUv2/data.py`): the whole zip held in memory, the csv's (image, depth)
rows in a shuffled order (`:71-85`), the train augmentations (50%
horizontal flip, channel swap with p=0.1, gamma drawn in (1/0.8, 0.8),
`:22-68,205-214`), and ToTensor's geometry: a 16-px border crop, the
image resized to 640x480 (or 224x224) and the depth to 320x240, train
depth x1000 clamped to [10, 1000] (centimetres), test depth /1000
(`:107-140`). The reference's train and "test" loaders both read
nyu2_train (`:216-223`), and so do these.

The shuffled order is `np.random.RandomState(0)`'s shuffle of
arange(n), which is what the JAX package's
`sklearn.utils.shuffle(rows, random_state=0)` computes; the port needs no
sklearn. Items are assembled with PIL and numpy only. Batches come from
`data/loader.parallel_batches`, which calls `item(index, rng)`.
"""

from __future__ import annotations

import random
from io import BytesIO
from itertools import permutations
from zipfile import ZipFile

import numpy as np
from PIL import Image

_PERMS = list(permutations(range(3), 3))
CROP = 16


def shuffled_order(n: int) -> np.ndarray:
    """The row order of `load_zip_to_mem`: RandomState(0)'s shuffle of
    arange(n) (sklearn's shuffle(random_state=0), and RandomState(0)'s
    permutation(n), give the same)."""
    order = np.arange(n)
    np.random.RandomState(0).shuffle(order)
    return order


def load_zip_to_mem(zip_file: str, list_name: str = "data/nyu2_train.csv"):
    """-> (member name: bytes dict, the shuffled [image, depth] rows)."""
    with ZipFile(zip_file) as zf:
        data = {name: zf.read(name) for name in zf.namelist()}
    rows = [r.split(",") for r in
            data[list_name].decode("utf-8").split("\n") if len(r) > 0]
    return data, [rows[i] for i in shuffled_order(len(rows))]


def _to_float(img: Image.Image) -> np.ndarray:
    arr = np.asarray(img, np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr / 255.0


def _depth_to_float(img: Image.Image) -> np.ndarray:
    """The reference's `to_tensor` for depth maps (`data.py:142-173`):
    8-bit images divide by 255; integer-mode images ('I', 'I;16': NYU's
    16-bit PNGs in millimetres) keep their raw values."""
    arr = np.asarray(img, np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    if getattr(img, "mode", None) in ("I", "I;16"):
        return arr
    return arr / 255.0


def gamma_lut(g: float) -> np.ndarray:
    """The reference's per-pixel 255 * (x / 255) ** g (`data.py:205-214`)
    as a 256-entry uint8 table: the same values, since it is pointwise
    on uint8 pixels."""
    return (255.0 * np.power(np.arange(256, dtype=np.float32) / 255.0,
                             np.float32(g))).astype(np.uint8)


class NyuDepthDataset:
    """`depthDatasetMemory` and its transforms in one class."""

    def __init__(self, data: dict, pairs, is_train: bool = True,
                 is_test: bool = False, is_224: bool = False,
                 gamma: float = 0.8, channel_swap_p: float = 0.1,
                 seed: int = 0, uint8_feed: bool = False):
        """uint8_feed=True returns the resized uint8 arrays and leaves the
        float cast and the centimetre clamp to the card
        (`ops/augment.expand_nyu`), which gives the float feed's bits.
        Test-transform items (is_test) and 16-bit depth maps take the
        float path per array."""
        self.data = data
        self.pairs = pairs
        self.is_train = is_train
        self.is_test = is_test
        self.is_224 = is_224
        self.gamma = gamma
        self.channel_swap_p = channel_swap_p
        self.rng = random.Random(seed)
        self.uint8_feed = uint8_feed

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int) -> dict:
        return self.item(idx)

    def item(self, idx: int, rng=None) -> dict:
        """One item; `rng` (a random.Random) keys the augmentation draws,
        the dataset's own sequential one by default."""
        rng = rng if rng is not None else self.rng
        img_name, depth_name = self.pairs[idx][0], self.pairs[idx][1]
        image = Image.open(BytesIO(self.data[img_name])).convert("RGB")
        depth = Image.open(BytesIO(self.data[depth_name]))

        if self.is_train:
            if rng.random() < 0.5:
                image = image.transpose(Image.FLIP_LEFT_RIGHT)
                depth = depth.transpose(Image.FLIP_LEFT_RIGHT)
            if rng.random() < self.channel_swap_p:
                perm = _PERMS[rng.randint(0, len(_PERMS) - 1)]
                image = Image.fromarray(np.asarray(image)[..., list(perm)])
            if self.gamma:
                g = rng.uniform(1.0 / self.gamma, self.gamma)
                image = Image.fromarray(gamma_lut(g)[np.asarray(image)])

        box = (CROP, CROP, 640 - CROP, 480 - CROP)
        image, depth = image.crop(box), depth.crop(box)
        if self.is_224:
            image, depth = image.resize((224, 224)), depth.resize((224, 224))
        else:
            image, depth = image.resize((640, 480)), depth.resize((320, 240))

        if self.uint8_feed and not self.is_test:
            d = np.asarray(depth)
            if d.dtype == np.uint8:
                depth_arr = d[..., None] if d.ndim == 2 else d
            else:       # 16-bit depth png: raw values x1000, clamped here
                depth_arr = np.clip(_depth_to_float(depth) * 1000.0,
                                    10.0, 1000.0)
            return {"image": np.asarray(image, np.uint8), "depth": depth_arr}
        depth_arr = _depth_to_float(depth)
        # ToTensor (`data.py:132-139`): /1000 for is_test, x1000 otherwise;
        # the [10, 1000] clamp applies to both
        depth_arr = depth_arr / 1000.0 if self.is_test else depth_arr * 1000.0
        return {"image": _to_float(image),
                "depth": np.clip(depth_arr, 10.0, 1000.0)}


def get_training_testing_data(zip_path: str, is_224: bool = False,
                              seed: int = 0, uint8_feed: bool = False):
    """`getTrainingTestingData` (`data.py:216-223`) without the
    DataLoader: (train dataset, test dataset), both over nyu2_train, as
    in the reference."""
    data, pairs = load_zip_to_mem(zip_path)
    train = NyuDepthDataset(data, pairs, is_train=True, is_224=is_224,
                            seed=seed, uint8_feed=uint8_feed)
    test = NyuDepthDataset(data, pairs, is_train=False, is_224=is_224,
                           seed=seed, uint8_feed=uint8_feed)
    return train, test


def batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                   drop_last: bool = True, seed: int = 0, epochs=None):
    """Sequential batches (the dataset's own rng draws the augmentation):
    the JAX package's `batch_iterator`. The CLI loads with
    `data/loader.parallel_batches` instead."""
    if drop_last and len(dataset) < batch_size:
        raise ValueError(
            f"dataset has {len(dataset)} items < batch_size={batch_size} "
            f"with drop_last: no batch can ever be yielded")
    order = np.arange(len(dataset))
    rng = np.random.RandomState(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        if shuffle:
            rng.shuffle(order)
        for start in range(0, len(order), batch_size):
            idx = order[start:start + batch_size]
            if len(idx) < batch_size and drop_last:
                continue
            items = [dataset[int(i)] for i in idx]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
        epoch += 1
