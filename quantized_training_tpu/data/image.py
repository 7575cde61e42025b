"""Image datasets + transforms (data/image.py analog, torch-free).

Parity surface:
  - :func:`decode_image` (data/image.py:16-22) via PIL, RGB + EXIF
  - :class:`HFImageDataset` (data/image.py:27-52): streaming HF dataset
    with jpg/cls columns
  - :class:`WebDataset` (data/image.py:55-143): tar-shard streaming with
    round-robin shard->process assignment (:106-112) and skip-shard-on-
    error fault tolerance (:141-143). URLs may be http(s) OR local paths,
    so the format is testable in zero-egress environments.
  - :class:`SyntheticImageDataset` for benchmarks.

Transforms are numpy/PIL implementations of the torchvision v2 pipeline the
reference drivers use (timm_finetune.py:67-76): RandomResizedCrop(224) +
HFlip for train; Resize(256) + CenterCrop(224) for eval; ImageNet
normalization. Output is NHWC fp32 (channels-last).
"""

from __future__ import annotations

import io
import logging
import tarfile

import numpy as np

logger = logging.getLogger(__name__)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def decode_image(data: bytes):
    """bytes -> PIL RGB image with EXIF orientation applied."""
    from PIL import Image, ImageOps

    img = Image.open(io.BytesIO(data))
    img = ImageOps.exif_transpose(img)
    return img.convert("RGB")


def _to_array(img) -> np.ndarray:
    return np.asarray(img, np.float32) / 255.0


def normalize(x: np.ndarray) -> np.ndarray:
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def train_transform(img, size: int = 224, rng: np.random.Generator | None = None):
    """RandomResizedCrop(size) + RandomHorizontalFlip + normalize -> NHWC."""
    from PIL import Image

    rng = rng or np.random.default_rng()
    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(0.08, 1.0)
        ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(target_area * ar)))
        ch = int(round(np.sqrt(target_area / ar)))
        if cw <= w and ch <= h:
            x0 = rng.integers(0, w - cw + 1)
            y0 = rng.integers(0, h - ch + 1)
            img = img.crop((x0, y0, x0 + cw, y0 + ch))
            break
    else:  # fallback: center crop
        s = min(w, h)
        img = img.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
    img = img.resize((size, size), Image.BILINEAR)
    if rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return normalize(_to_array(img))


def eval_transform(img, size: int = 224, resize: int = 256):
    """Resize(resize) + CenterCrop(size) + normalize -> NHWC."""
    from PIL import Image

    w, h = img.size
    scale = resize / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)), Image.BILINEAR)
    w, h = img.size
    x0, y0 = (w - size) // 2, (h - size) // 2
    img = img.crop((x0, y0, x0 + size, y0 + size))
    return normalize(_to_array(img))


class SyntheticImageDataset:
    def __init__(
        self,
        size: int = 224,
        num_classes: int = 1000,
        eval: bool = False,
        n_samples: int | None = None,
        seed: int = 2024,
    ):
        self.size = size
        self.num_classes = num_classes
        self.n_samples = n_samples if n_samples is not None else (256 if eval else None)
        self.seed = seed
        self._i = 0

    def __iter__(self):
        while self.n_samples is None or self._i < self.n_samples:
            rng = np.random.Generator(np.random.PCG64([self.seed, self._i]))
            img = rng.normal(size=(self.size, self.size, 3)).astype(np.float32)
            label = int(rng.integers(0, self.num_classes))
            self._i += 1
            yield img, label

    def state_dict(self):
        return dict(_i=self._i)

    def load_state_dict(self, state):
        self._i = state["_i"]


class HFImageDataset:
    """Streaming HF image dataset with 'jpg'/'cls' columns
    (data/image.py:27-52)."""

    def __init__(self, dataset: str, split: str, eval: bool = False, transform=None):
        from datasets import load_dataset

        self.ds = load_dataset(dataset, split=split, streaming=True)
        self.eval = eval
        self.transform = transform

    def __iter__(self):
        epoch = 0
        while True:
            ds = self.ds if self.eval else self.ds.shuffle(seed=epoch)
            for sample in ds.select_columns(["jpg", "cls"]):
                img = sample["jpg"].convert("RGB")
                if self.transform is not None:
                    img = self.transform(img)
                yield img, sample["cls"]
            epoch += 1
            if self.eval:
                break


class WebDataset:
    """Generic tar-shard streaming (data/image.py:55-143).

    ``urls`` may be http(s) URLs or local tar paths. Each process takes one
    shard in every ``process_count`` (round-robin, :106-112); any shard
    error logs and skips to the next shard (:141-143).
    """

    def __init__(
        self,
        urls: list[str],
        columns: list[str] | None = None,
        transform: dict | None = None,
        eval: bool = True,
        seed: int = 2024,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.urls = list(urls)
        self.columns = tuple(columns) if columns is not None else None
        self.transform = dict(transform) if transform is not None else None
        self.eval = eval
        self.process_index = process_index
        self.process_count = process_count
        self._rng = np.random.Generator(np.random.PCG64(seed))

    def _url_iter(self):
        while True:
            order = (
                range(len(self.urls))
                if self.eval
                else self._rng.permutation(len(self.urls))
            )
            for idx in order:
                yield self.urls[idx]
            if self.eval:
                break

    def _open(self, url: str):
        if url.startswith(("http://", "https://")):
            import requests

            resp = requests.get(url, timeout=30, stream=True)
            resp.raise_for_status()
            return tarfile.open(fileobj=resp.raw, mode="r|")
        return tarfile.open(url, mode="r|")

    def _emit(self, sample: dict):
        if self.transform is not None:
            for k, fn in self.transform.items():
                if k in sample:
                    sample[k] = fn(sample[k])
        return sample

    def __iter__(self):
        for shard_idx, url in enumerate(self._url_iter()):
            if shard_idx % self.process_count != self.process_index:
                continue
            try:
                tar = self._open(url)
                sample: dict = {}
                for tarinfo in tar:
                    key, ext = tarinfo.name.rsplit(".", 1)
                    if "__key__" in sample and sample["__key__"] != key:
                        yield self._emit(sample)
                        sample = {"__key__": key}
                    elif "__key__" not in sample:
                        sample["__key__"] = key
                    if self.columns is None or ext in self.columns:
                        sample[ext] = tar.extractfile(tarinfo).read()
                if "__key__" in sample:
                    yield self._emit(sample)
            except Exception as e:
                logger.exception(f"Exception while reading {url=}. {e}")
