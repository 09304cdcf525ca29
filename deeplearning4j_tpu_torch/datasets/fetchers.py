"""Dataset fetchers: the port of the offline parts of
`deeplearning4j_tpu/datasets/fetchers.py`. The 384 bundled MNIST digits
(the port's own copy, `deeplearning4j_tpu_torch/resources/
mnist_subset.npz`) with the JAX package's shuffled and stratified splits
and its augmentation; Iris (embedded); Curves (generated from a seed);
the IDX reader; and the MNIST (IDX), CIFAR-10 (binary batches) and LFW
(person-named image directories) fetchers over a local cache.

Nothing is downloaded. A fetcher reads `cache` (default
$DL4J_TPU_DATA_DIR/<dataset>, else ~/.deeplearning4j_tpu/<dataset>, the
JAX package's layout); a cache miss raises FileNotFoundError naming the
files to place there. A CIFAR-10 or LFW tarball in the cache is extracted.
"""
from __future__ import annotations

import gzip
import os
import struct
import tarfile
from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "data_dir", "read_idx", "MnistDataFetcher", "IrisDataFetcher",
    "CifarDataFetcher", "LFWDataFetcher", "CurvesDataFetcher",
    "IRIS_FEATURES", "IRIS_LABELS", "bundled_mnist_subset",
    "bundled_mnist_stratified", "augment_digits",
]


def bundled_mnist_subset(train_count: int = 320, seed: int = 0):
    """(x_train [N, 784] float32 in [0, 1], y_train one-hot [N, 10], x_test,
    y_test): the 384 bundled digits in a seeded permutation, the first
    `train_count` for training (the JAX package's split)."""
    imgs, labels = _bundled_mnist_raw()
    x = imgs.astype(np.float32) / 255.0
    y = labels
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(x))
    x, y = x[order].reshape(len(x), -1), y[order]
    oh = np.eye(10, dtype=np.float32)[y]
    return (x[:train_count], oh[:train_count],
            x[train_count:], oh[train_count:])

def _bundled_mnist_raw():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "resources", "mnist_subset.npz")
    with np.load(path) as z:
        return z["images"].astype(np.uint8), z["labels"].astype(np.int64)


def bundled_mnist_stratified(test_per_class: int = 4, seed: int = 0):
    """Stratified split of the bundled 384 real digits: `test_per_class`
    held-out digits per class (balanced eval set), the rest train.
    Returns (train_images [N,28,28] u8, train_labels, test_images,
    test_labels) — raw pixels, for use with `augment_digits`."""
    imgs, labels = _bundled_mnist_raw()
    rng = np.random.default_rng(seed)
    te = []
    for c in range(10):
        idx = np.where(labels == c)[0]
        te.extend(rng.permutation(idx)[:test_per_class])
    te = np.array(sorted(te))
    tr = np.setdiff1d(np.arange(len(imgs)), te)
    return imgs[tr], labels[tr], imgs[te], labels[te]


def augment_digits(images, labels, n_aug: int = 7, seed: int = 0):
    """Label-preserving MNIST augmentation: small rotation, affine
    shear/zoom/shift, and elastic deformation (Simard 2003 — the classic
    MNIST recipe). Stretches the offline real-digit budget (384 bundled
    digits, zero-egress environment) into a training set large enough for
    the >=97% convergence gate; evaluation stays on untouched real
    pixels. Returns ([N*(1+n_aug), 784] f32 in [0,1], one-hot labels)."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)

    def elastic(img, alpha=6.0, sigma=3.5):
        dx = ndimage.gaussian_filter(rng.uniform(-1, 1, (28, 28)), sigma) * alpha
        dy = ndimage.gaussian_filter(rng.uniform(-1, 1, (28, 28)), sigma) * alpha
        yy, xx = np.meshgrid(np.arange(28), np.arange(28), indexing="ij")
        return ndimage.map_coordinates(img, [yy + dy, xx + dx],
                                       order=1).reshape(28, 28)

    def one(img):
        out = img.astype(np.float32)
        out = ndimage.rotate(out, rng.uniform(-12, 12), reshape=False,
                             order=1)
        sh = rng.uniform(-0.08, 0.08, 2)
        zm = rng.uniform(0.9, 1.1)
        mat = np.array([[zm, sh[0]], [sh[1], zm]])
        c = 13.5
        off = c - mat @ np.array([c, c]) + rng.uniform(-2, 2, 2)
        out = ndimage.affine_transform(out, mat, offset=off, order=1)
        if rng.random() < 0.7:
            out = elastic(out)
        return np.clip(out, 0, 255)

    xs, ys = [], []
    for img, lab in zip(images, labels):
        xs.append(img.astype(np.float32))
        ys.append(lab)
        for _ in range(n_aug):
            xs.append(one(img))
            ys.append(lab)
    x = (np.stack(xs) / 255.0).reshape(len(xs), -1).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[np.array(ys)]
    return x, y


_MNIST_FILES = {
    "train_images": "train-images-idx3-ubyte.gz",
    "train_labels": "train-labels-idx1-ubyte.gz",
    "test_images": "t10k-images-idx3-ubyte.gz",
    "test_labels": "t10k-labels-idx1-ubyte.gz",
}


def data_dir(dataset: str = "") -> str:
    root = os.environ.get("DL4J_TPU_DATA_DIR",
                          os.path.expanduser("~/.deeplearning4j_tpu"))
    path = os.path.join(root, dataset) if dataset else root
    os.makedirs(path, exist_ok=True)
    return path


def read_idx(path: str) -> np.ndarray:
    """Parse an IDX file (optionally .gz): magic = 0x00 0x00 <dtype> <ndim>.
    MNIST uses dtype 0x08 (ubyte) with ndim 1 (labels) or 3 (images).
    Uncompressed files go through the native C++ decoder
    (`native/dl4j_native.cpp`, the reference's `datasets/mnist/` reader
    analog), as in the JAX package."""
    if not path.endswith(".gz"):
        from ..native import idx_read_native
        return idx_read_native(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    zero, dtype_code, ndim = struct.unpack(">HBB", data[:4])
    if zero != 0:
        raise ValueError(f"{path}: bad IDX magic {data[:4]!r}")
    dtypes = {0x08: np.uint8, 0x09: np.int8, 0x0B: ">i2", 0x0C: ">i4",
              0x0D: ">f4", 0x0E: ">f8"}
    if dtype_code not in dtypes:
        raise ValueError(f"{path}: unknown IDX dtype 0x{dtype_code:02x}")
    dims = struct.unpack(">" + "I" * ndim, data[4:4 + 4 * ndim])
    arr = np.frombuffer(data, dtype=dtypes[dtype_code], offset=4 + 4 * ndim)
    if arr.size != int(np.prod(dims)):
        raise ValueError(f"{path}: payload size {arr.size} != shape {dims}")
    return arr.reshape(dims)


class MnistDataFetcher:
    """70k 28x28 grayscale digits. `fetch(train)` -> (images [N,784] float32
    in [0,1] (or binarized), labels one-hot [N,10])."""

    NUM_EXAMPLES = 60000
    NUM_EXAMPLES_TEST = 10000

    def __init__(self, binarize: bool = False, train: bool = True,
                 shuffle: bool = False, seed: Optional[int] = None,
                 cache: Optional[str] = None):
        self.binarize = binarize
        self.train = train
        self.shuffle = shuffle
        self.seed = seed
        self.cache = cache or data_dir("mnist")

    def _file(self, key: str) -> str:
        fname = _MNIST_FILES[key]
        dest = os.path.join(self.cache, fname)
        raw = dest[:-3]  # pre-extracted variant also accepted
        if os.path.exists(dest) or os.path.exists(raw):
            return dest if os.path.exists(dest) else raw
        raise FileNotFoundError(
            f"MNIST file {fname} (or {fname[:-3]}) is not in the cache "
            f"{self.cache}; place the IDX files there (nothing is "
            "downloaded)")

    def fetch(self) -> Tuple[np.ndarray, np.ndarray]:
        prefix = "train" if self.train else "test"
        images = read_idx(self._file(f"{prefix}_images"))
        labels = read_idx(self._file(f"{prefix}_labels"))
        flat = images.reshape(images.shape[0], -1)
        if flat.dtype == np.uint8:
            # the native scaling, x * float32(1/255) (the JAX package's
            # native tier: 126 of the 256 byte values are one ulp from
            # x / 255); threshold 127 == (x / 255 > 0.5)
            from ..native import u8_to_f32
            x = u8_to_f32(flat, binarize=self.binarize, threshold=127)
        else:
            x = flat.astype(np.float32) / 255.0
            if self.binarize:
                x = (x > 0.5).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[labels.astype(np.int64)]
        if self.shuffle:
            rng = np.random.default_rng(self.seed)
            idx = rng.permutation(x.shape[0])
            x, y = x[idx], y[idx]
        return x, y


# The classic Fisher/Anderson Iris data (150 rows, public domain), embedded
# the way the reference ships it as a bundled resource.
_IRIS_ROWS = """
5.1,3.5,1.4,0.2,0;4.9,3.0,1.4,0.2,0;4.7,3.2,1.3,0.2,0;4.6,3.1,1.5,0.2,0;
5.0,3.6,1.4,0.2,0;5.4,3.9,1.7,0.4,0;4.6,3.4,1.4,0.3,0;5.0,3.4,1.5,0.2,0;
4.4,2.9,1.4,0.2,0;4.9,3.1,1.5,0.1,0;5.4,3.7,1.5,0.2,0;4.8,3.4,1.6,0.2,0;
4.8,3.0,1.4,0.1,0;4.3,3.0,1.1,0.1,0;5.8,4.0,1.2,0.2,0;5.7,4.4,1.5,0.4,0;
5.4,3.9,1.3,0.4,0;5.1,3.5,1.4,0.3,0;5.7,3.8,1.7,0.3,0;5.1,3.8,1.5,0.3,0;
5.4,3.4,1.7,0.2,0;5.1,3.7,1.5,0.4,0;4.6,3.6,1.0,0.2,0;5.1,3.3,1.7,0.5,0;
4.8,3.4,1.9,0.2,0;5.0,3.0,1.6,0.2,0;5.0,3.4,1.6,0.4,0;5.2,3.5,1.5,0.2,0;
5.2,3.4,1.4,0.2,0;4.7,3.2,1.6,0.2,0;4.8,3.1,1.6,0.2,0;5.4,3.4,1.5,0.4,0;
5.2,4.1,1.5,0.1,0;5.5,4.2,1.4,0.2,0;4.9,3.1,1.5,0.2,0;5.0,3.2,1.2,0.2,0;
5.5,3.5,1.3,0.2,0;4.9,3.6,1.4,0.1,0;4.4,3.0,1.3,0.2,0;5.1,3.4,1.5,0.2,0;
5.0,3.5,1.3,0.3,0;4.5,2.3,1.3,0.3,0;4.4,3.2,1.3,0.2,0;5.0,3.5,1.6,0.6,0;
5.1,3.8,1.9,0.4,0;4.8,3.0,1.4,0.3,0;5.1,3.8,1.6,0.2,0;4.6,3.2,1.4,0.2,0;
5.3,3.7,1.5,0.2,0;5.0,3.3,1.4,0.2,0;7.0,3.2,4.7,1.4,1;6.4,3.2,4.5,1.5,1;
6.9,3.1,4.9,1.5,1;5.5,2.3,4.0,1.3,1;6.5,2.8,4.6,1.5,1;5.7,2.8,4.5,1.3,1;
6.3,3.3,4.7,1.6,1;4.9,2.4,3.3,1.0,1;6.6,2.9,4.6,1.3,1;5.2,2.7,3.9,1.4,1;
5.0,2.0,3.5,1.0,1;5.9,3.0,4.2,1.5,1;6.0,2.2,4.0,1.0,1;6.1,2.9,4.7,1.4,1;
5.6,2.9,3.6,1.3,1;6.7,3.1,4.4,1.4,1;5.6,3.0,4.5,1.5,1;5.8,2.7,4.1,1.0,1;
6.2,2.2,4.5,1.5,1;5.6,2.5,3.9,1.1,1;5.9,3.2,4.8,1.8,1;6.1,2.8,4.0,1.3,1;
6.3,2.5,4.9,1.5,1;6.1,2.8,4.7,1.2,1;6.4,2.9,4.3,1.3,1;6.6,3.0,4.4,1.4,1;
6.8,2.8,4.8,1.4,1;6.7,3.0,5.0,1.7,1;6.0,2.9,4.5,1.5,1;5.7,2.6,3.5,1.0,1;
5.5,2.4,3.8,1.1,1;5.5,2.4,3.7,1.0,1;5.8,2.7,3.9,1.2,1;6.0,2.7,5.1,1.6,1;
5.4,3.0,4.5,1.5,1;6.0,3.4,4.5,1.6,1;6.7,3.1,4.7,1.5,1;6.3,2.3,4.4,1.3,1;
5.6,3.0,4.1,1.3,1;5.5,2.5,4.0,1.3,1;5.5,2.6,4.4,1.2,1;6.1,3.0,4.6,1.4,1;
5.8,2.6,4.0,1.2,1;5.0,2.3,3.3,1.0,1;5.6,2.7,4.2,1.3,1;5.7,3.0,4.2,1.2,1;
5.7,2.9,4.2,1.3,1;6.2,2.9,4.3,1.3,1;5.1,2.5,3.0,1.1,1;5.7,2.8,4.1,1.3,1;
6.3,3.3,6.0,2.5,2;5.8,2.7,5.1,1.9,2;7.1,3.0,5.9,2.1,2;6.3,2.9,5.6,1.8,2;
6.5,3.0,5.8,2.2,2;7.6,3.0,6.6,2.1,2;4.9,2.5,4.5,1.7,2;7.3,2.9,6.3,1.8,2;
6.7,2.5,5.8,1.8,2;7.2,3.6,6.1,2.5,2;6.5,3.2,5.1,2.0,2;6.4,2.7,5.3,1.9,2;
6.8,3.0,5.5,2.1,2;5.7,2.5,5.0,2.0,2;5.8,2.8,5.1,2.4,2;6.4,3.2,5.3,2.3,2;
6.5,3.0,5.5,1.8,2;7.7,3.8,6.7,2.2,2;7.7,2.6,6.9,2.3,2;6.0,2.2,5.0,1.5,2;
6.9,3.2,5.7,2.3,2;5.6,2.8,4.9,2.0,2;7.7,2.8,6.7,2.0,2;6.3,2.7,4.9,1.8,2;
6.7,3.3,5.7,2.1,2;7.2,3.2,6.0,1.8,2;6.2,2.8,4.8,1.8,2;6.1,3.0,4.9,1.8,2;
6.4,2.8,5.6,2.1,2;7.2,3.0,5.8,1.6,2;7.4,2.8,6.1,1.9,2;7.9,3.8,6.4,2.0,2;
6.4,2.8,5.6,2.2,2;6.3,2.8,5.1,1.5,2;6.1,2.6,5.6,1.4,2;7.7,3.0,6.1,2.3,2;
6.3,3.4,5.6,2.4,2;6.4,3.1,5.5,1.8,2;6.0,3.0,4.8,1.8,2;6.9,3.1,5.4,2.1,2;
6.7,3.1,5.6,2.4,2;6.9,3.1,5.1,2.3,2;5.8,2.7,5.1,1.9,2;6.8,3.2,5.9,2.3,2;
6.7,3.3,5.7,2.5,2;6.7,3.0,5.2,2.3,2;6.3,2.5,5.0,1.9,2;6.5,3.0,5.2,2.0,2;
6.2,3.4,5.4,2.3,2;5.9,3.0,5.1,1.8,2
""".replace("\n", "")

_iris = np.array([[float(v) for v in row.split(",")]
                  for row in _IRIS_ROWS.strip(";").split(";")],
                 dtype=np.float32)
IRIS_FEATURES: np.ndarray = _iris[:, :4]
IRIS_LABELS: np.ndarray = np.eye(3, dtype=np.float32)[
    _iris[:, 4].astype(np.int64)]


class IrisDataFetcher:
    NUM_EXAMPLES = 150

    def __init__(self, shuffle: bool = False, seed: Optional[int] = None,
                 normalize: bool = True):
        self.shuffle = shuffle
        self.seed = seed
        self.normalize = normalize

    def fetch(self) -> Tuple[np.ndarray, np.ndarray]:
        x, y = IRIS_FEATURES.copy(), IRIS_LABELS.copy()
        if self.normalize:
            x = (x - x.mean(axis=0)) / x.std(axis=0)
        if self.shuffle:
            rng = np.random.default_rng(self.seed)
            idx = rng.permutation(x.shape[0])
            x, y = x[idx], y[idx]
        return x, y


class CifarDataFetcher:
    """CIFAR-10 binary format: records of 1 label byte + 32*32*3 bytes in
    channel-major (R plane, G plane, B plane) order; returned NHWC float32
    in [0,1], labels one-hot [N,10]."""

    NUM_TRAIN = 50000
    NUM_TEST = 10000

    def __init__(self, train: bool = True, cache: Optional[str] = None):
        self.train = train
        self.cache = cache or data_dir("cifar10")

    def _batch_files(self) -> List[str]:
        names = ([f"data_batch_{i}.bin" for i in range(1, 6)]
                 if self.train else ["test_batch.bin"])
        found = []
        for name in names:
            for cand in (os.path.join(self.cache, name),
                         os.path.join(self.cache, "cifar-10-batches-bin",
                                      name)):
                if os.path.exists(cand):
                    found.append(cand)
                    break
        if len(found) == len(names):
            return found
        # cache miss: extract the official tarball if it is there
        tarball = os.path.join(self.cache, "cifar-10-binary.tar.gz")
        if not os.path.exists(tarball):
            raise FileNotFoundError(
                f"CIFAR-10 batches are not in the cache {self.cache}; place "
                "data_batch_*.bin / test_batch.bin or "
                "cifar-10-binary.tar.gz there (nothing is downloaded)")
        with tarfile.open(tarball, "r:gz") as tf:
            tf.extractall(self.cache, filter="data")
        return self._batch_files()

    def fetch(self) -> Tuple[np.ndarray, np.ndarray]:
        xs, ys = [], []
        for path in self._batch_files():
            raw = np.frombuffer(open(path, "rb").read(), dtype=np.uint8)
            rec = raw.reshape(-1, 3073)
            ys.append(rec[:, 0])
            xs.append(rec[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        x = np.concatenate(xs).astype(np.float32) / 255.0
        y = np.eye(10, dtype=np.float32)[np.concatenate(ys).astype(np.int64)]
        return x, y




class LFWDataFetcher:
    """Labeled Faces in the Wild (reference `LFWDataSetIterator.java` /
    `datasets/fetchers/LFWDataFetcher.java`): person-labeled face JPEGs.
    `fetch()` -> (images [N, H, W, 3] float32 in [0,1], labels one-hot over
    the `num_labels` most frequent people), from `lfw.tgz` or the extracted
    `lfw/` tree in the cache."""

    def __init__(self, image_size: int = 64, num_labels: int = 0,
                 min_images_per_person: int = 1,
                 cache: Optional[str] = None):
        self.image_size = int(image_size)
        self.num_labels = int(num_labels)
        self.min_images = int(min_images_per_person)
        self.cache = cache or data_dir("lfw")

    def _root(self) -> str:
        root = os.path.join(self.cache, "lfw")
        if os.path.isdir(root):
            return root
        tarball = os.path.join(self.cache, "lfw.tgz")
        if not os.path.exists(tarball):
            raise FileNotFoundError(
                f"LFW is not in the cache {self.cache}; place lfw.tgz or "
                "the extracted lfw/ directory there (nothing is "
                "downloaded)")
        with tarfile.open(tarball, "r:gz") as tf:
            tf.extractall(self.cache, filter="data")
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"{tarball} did not extract an 'lfw/' directory; expected "
                "the official LFW tarball layout (person-named "
                "subdirectories under lfw/)")
        return root

    def _counted(self, root: str):
        """[(person, image files)] after min-images filtering and
        num_labels selection — the single definition of class ordering."""
        counted = []
        for person in sorted(
                d for d in os.listdir(root)
                if os.path.isdir(os.path.join(root, d))):
            files = sorted(
                f for f in os.listdir(os.path.join(root, person))
                if f.lower().endswith((".jpg", ".jpeg", ".png")))
            if len(files) >= self.min_images:
                counted.append((person, files))
        if self.num_labels > 0:
            counted.sort(key=lambda pf: (-len(pf[1]), pf[0]))
            counted = counted[: self.num_labels]
            counted.sort(key=lambda pf: pf[0])
        return counted

    def fetch(self) -> Tuple[np.ndarray, np.ndarray]:
        # decode through the image reader's loader (PIL)
        from .images import ImageLoader

        root = self._root()
        counted = self._counted(root)
        xs, ys = [], []
        s = self.image_size
        loader = ImageLoader(s, s, 3)
        for label, (person, files) in enumerate(counted):
            for f in files:
                xs.append(loader.load(os.path.join(root, person, f))
                          .astype(np.float32))
                ys.append(label)
        n_cls = len(counted)
        x = np.stack(xs) if xs else np.zeros((0, s, s, 3), np.float32)
        y = (np.eye(n_cls, dtype=np.float32)[np.asarray(ys, np.int64)]
             if xs else np.zeros((0, n_cls), np.float32))
        return x, y

    def labels(self) -> List[str]:
        """Person names in class-index order — labels()[k] names one-hot
        column k of fetch()'s labels."""
        return [p for p, _ in self._counted(self._root())]


class CurvesDataFetcher:
    """Synthetic "curves" dataset (the deep-autoencoder benchmark of
    DL4J's `CurvesDataFetcher`: 28x28 images of smooth random curves),
    generated from a seed as the JAX package generates it (quadratic
    Bezier strokes rasterized with anti-aliasing)."""

    def __init__(self, n_examples: int = 10000, image_size: int = 28,
                 seed: int = 123):
        self.n = int(n_examples)
        self.size = int(image_size)
        self.seed = int(seed)

    def fetch(self) -> Tuple[np.ndarray, np.ndarray]:
        r = np.random.default_rng(self.seed)
        s = self.size
        t = np.linspace(0.0, 1.0, 64)[:, None]          # curve parameter
        # control points for quadratic Bezier curves, [N, 3, 2] in [0, s)
        ctrl = r.uniform(2, s - 2, size=(self.n, 3, 2))
        pts = ((1 - t) ** 2 * ctrl[:, None, 0]
               + 2 * (1 - t) * t * ctrl[:, None, 1]
               + t ** 2 * ctrl[:, None, 2])             # [N, T, 2]
        imgs = np.zeros((self.n, s, s), np.float32)
        ij = np.floor(pts).astype(np.int64)
        frac = pts - ij
        n_idx = np.repeat(np.arange(self.n), t.shape[0])
        for dy in (0, 1):
            for dx in (0, 1):
                yy = np.clip(ij[..., 1] + dy, 0, s - 1).ravel()
                xx = np.clip(ij[..., 0] + dx, 0, s - 1).ravel()
                w = (np.abs(1 - dy - frac[..., 1])
                     * np.abs(1 - dx - frac[..., 0])).ravel()
                np.add.at(imgs, (n_idx, yy, xx), w)
        x = np.clip(imgs, 0.0, 1.0).reshape(self.n, -1)
        return x, x.copy()   # autoencoder dataset: target == input
