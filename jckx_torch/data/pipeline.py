"""Input pipeline — port of ``jckx/data/pipeline.py``: ``decode_batch``
(``:34-48``), ``DeviceDataLoader`` (``:51-107``), ``HostStreamLoader``
(``:110-169``), ``DCGANDataPreprocessor`` (``:176-236``) and
``CGANDataPreprocessor`` (``:238-247``), plus ``PinnedSlabs``, the
host→device upload the streaming plane and the metrics engine share.

Two data planes, as in jckx. The resident plane keeps the uint8 set on the
device (the trainer uploads it once) and gathers each batch there by
index. The streaming plane keeps the set on the host (ideally the native
cache's read-only mapping) and, per launch of K steps, gathers the K·bs
rows into one contiguous slab with the C++ gather over ``-w`` threads
(``HostStreamLoader``), straight into a pinned host buffer, and uploads it
as one copy (``PinnedSlabs``). Either way each step decodes its batch on
the device: uint8 → [0, 1] → bilinear resize to the model's size →
[-1, 1], the reference's Resize(64) + ToTensor + Normalize(0.5, 0.5)
(dcgan_data_preprocessor.py:38-43).

``PinnedSlabs`` holds two pinned host slabs, used in turn: while one
slab's copy may still be in flight, the gather fills the other. Each copy
is ``non_blocking`` on a dedicated CUDA stream with an event recorded
after it; ``use`` makes the compute stream wait for that event and
records the device slab on the compute stream (the caching allocator
then cannot hand its memory to the next slab while a decode still reads
it). A host slab is refilled only after its previous copy's event has
completed, a wait that ``fill`` makes in the thread that gathers, never
in the train thread. On the CPU the same calls run with pageable buffers,
no stream and a plain copy.

``jax.image.resize(method="bilinear")`` samples at half-pixel centres and
renormalizes its triangle weights at the border. When it upsamples, that
is ``F.interpolate(mode="bilinear", align_corners=False)``; when it
downsamples, it widens the triangle by the scale, which is
``antialias=True`` (tests/test_torch_data.py holds both against jckx).
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from jckx_torch.data import native_io
from jckx_torch.data.datasets import load_dataset
from jckx_torch.logging.main_logger import MainLogger
from jckx_torch.utils.device import resolve_device


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """NHWC float → (N, size, size, C), as ``jax.image.resize`` bilinear."""
    if x.shape[1] == size and x.shape[2] == size:
        return x
    nchw = x.permute(0, 3, 1, 2)
    y = F.interpolate(nchw, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=size < max(x.shape[1], x.shape[2]))
    return y.permute(0, 2, 3, 1)


def decode_batch(u8: torch.Tensor, image_size: int,
                 compute_dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC → resized images in [-1, 1], NHWC, in ``compute_dtype``
    (the resize in f32, as jckx)."""
    x = resize_bilinear(u8.float() / 255.0, image_size)
    return ((x - 0.5) / 0.5).to(compute_dtype)


def device_copy(images_u8: np.ndarray, device) -> torch.Tensor:
    """The host array as a tensor on ``device`` that owns its bytes: one
    copy, also of a read-only view (the native cache's mapping is never
    handed to ``torch.from_numpy``)."""
    return torch.tensor(images_u8).to(device)


class DeviceDataLoader:
    """Epoch iterator over a uint8 set held on the device (``:51-107``):
    yields ``(batch_u8, labels)`` device tensors per step, in the order of
    one ``np.random.RandomState(seed)`` permutation per epoch (the
    reference's shuffle=True), dropping the incomplete last batch. The
    upload is lazy: the trainer keeps its own device copy, so an eager one
    here would hold the set twice."""

    def __init__(self, images_u8: np.ndarray, labels: np.ndarray, batch_size: int,
                 seed: int = 0, shuffle: bool = True, device=None):
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.device = resolve_device(device)
        self._rng = np.random.RandomState(seed)
        self._images_u8 = images_u8
        self.labels_np = np.asarray(labels)
        self._images_dev = self._labels_dev = None
        self.n = images_u8.shape[0]

    @property
    def images(self) -> torch.Tensor:
        if self._images_dev is None:
            self._images_dev = device_copy(self._images_u8, self.device)
        return self._images_dev

    @property
    def labels(self) -> torch.Tensor:
        if self._labels_dev is None:
            self._labels_dev = device_copy(self.labels_np, self.device)
        return self._labels_dev

    def __len__(self) -> int:
        return self.n // self.batch_size

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        order = self._rng.permutation(self.n) if self.shuffle else np.arange(self.n)
        bs = self.batch_size
        for i in range(len(self)):
            idx = torch.from_numpy(order[i * bs:(i + 1) * bs].astype(np.int64)).to(self.device)
            yield self.images.index_select(0, idx), self.labels.index_select(0, idx)


class HostStreamLoader:
    """The streaming plane's host side (``:110-169``): the set stays on the
    host, and ``take(rows)`` assembles the requested rows into one
    contiguous uint8 slab with the C++ gather split over ``workers``
    threads (the role of the reference DataLoader's ``num_worker``,
    dcgan_data_preprocessor.py:69-75), with their int32 labels. ``out``
    is the slab to fill (a pinned buffer's view); its bytes equal jckx's
    ``take`` for the same rows. The trainer runs ``take`` on its own
    uploader thread; a caller without one can ``prime`` the next rows
    (gather-only lookahead) and ``take`` them."""

    def __init__(self, images_u8: np.ndarray, labels: np.ndarray, workers: int = 0):
        self.images = images_u8
        self.labels_np = np.asarray(labels)
        self.workers = max(1, int(workers))
        self._pool = None  # created on first use; close() releases it
        self._primed = None  # (rows' bytes, future)

    def _ensure_pool(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            # one slot more than the workers: a primed block runs in it while its chunks fan out
            self._pool = ThreadPoolExecutor(self.workers + 1, thread_name_prefix="jckx-gather")
        return self._pool

    def close(self) -> None:
        """Release the gather threads (a later call creates them again)."""
        self._primed = None
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def _assemble(self, rows: np.ndarray, out: Optional[np.ndarray] = None):
        slab = native_io.gather_rows_mt(self.images, rows, self.workers,
                                        pool=self._ensure_pool(), out=out)
        return slab, self.labels_np[rows].astype(np.int32)

    def prime(self, rows: np.ndarray) -> None:
        """Start gathering ``rows`` in the background (the next launch's)."""
        rows = np.ascontiguousarray(rows, np.int32)
        self._primed = (rows.tobytes(), self._ensure_pool().submit(self._assemble, rows))

    def take(self, rows: np.ndarray, out: Optional[np.ndarray] = None):
        """→ (slab uint8, labels int32) for ``rows``: the primed result when
        it was primed for these rows, else a gather now."""
        rows = np.ascontiguousarray(rows, np.int32)
        if self._primed is not None:
            key, fut = self._primed
            self._primed = None
            if key == rows.tobytes():
                slab, labels = fut.result()
                if out is None:
                    return slab, labels
                np.copyto(out, slab)
                return out, labels
        return self._assemble(rows, out)


class DeviceSlab(NamedTuple):
    """One upload: the device tensors and the event recorded after their
    copy (None on the CPU)."""
    tensors: Tuple[torch.Tensor, ...]
    event: Optional["torch.cuda.Event"]


class PinnedSlabs:
    """Uploads of up to ``max_rows`` rows of each field in ``fields`` (a
    (row shape, torch dtype) pair each) through two pinned host slabs,
    used in turn, on a dedicated copy stream (see the module docstring).

    ``fill(n)`` → numpy views of the next host slab's first ``n`` rows, to
    write into, once that slab's previous copy has completed; ``upload(n)``
    copies them to the device (→ ``DeviceSlab``); ``use(slab)`` → the
    tensors, ready on the current stream. ``fill`` and ``upload`` may run
    on a thread of their own (one at a time); ``use`` runs on the thread
    that computes."""

    def __init__(self, device, fields: Sequence[Tuple[tuple, torch.dtype]], max_rows: int):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self._host = [[torch.empty((max_rows, *shape), dtype=dtype, pin_memory=cuda)
                       for shape, dtype in fields] for _ in range(2)]
        self._copied: List[Optional[torch.cuda.Event]] = [None, None]
        self._next = 0
        self.stream = torch.cuda.Stream(self.device) if cuda else None

    def fill(self, n: int) -> List[np.ndarray]:
        i = self._next
        if self._copied[i] is not None:
            self._copied[i].synchronize()  # that slab's last copy has read it
        return [t[:n].numpy() for t in self._host[i]]

    def upload(self, n: int) -> DeviceSlab:
        i, self._next = self._next, self._next ^ 1
        host = [t[:n] for t in self._host[i]]
        if self.stream is None:
            return DeviceSlab(tuple(h.clone() for h in host), None)
        with torch.cuda.stream(self.stream):
            dev = tuple(h.to(self.device, non_blocking=True) for h in host)
            event = torch.cuda.Event()
            event.record(self.stream)
        self._copied[i] = event
        return DeviceSlab(dev, event)

    def use(self, slab: DeviceSlab) -> Tuple[torch.Tensor, ...]:
        if slab.event is None:
            return slab.tensors
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(slab.event)
        for t in slab.tensors:
            t.record_stream(compute)
        return slab.tensors


class DCGANDataPreprocessor:
    """Unconditional data (reference dcgan_data_preprocessor.py:11-75):
    ``images_u8`` (N, H, W, C) and ``labels_np`` on the host, the class
    names, the per-channel ``data_mean`` / ``data_std`` the reference
    logs, and ``metric_source``, the (images, labels) pair the metrics
    engine extracts real features from. ``transform_data`` and
    ``get_data_loader`` keep the reference's call sequence (the trainer
    does not use them: it holds the set itself, resident or streamed)."""

    def __init__(self, cfg):
        logger = MainLogger(cfg)
        self.cfg = cfg
        x, y, ncls, names, synthetic = load_dataset(
            cfg.dataset, cfg.data_dir, train=True, seed=cfg.seed,
            num_classes=cfg.num_classes, synthetic_n=cfg.synthetic_size,
            data_path=cfg.data_path, image_size=cfg.image_size, channels=cfg.channels)
        if synthetic and cfg.dataset != "synthetic":
            logger.warning(
                f"dataset '{cfg.dataset}' not found under {cfg.data_dir}; "
                f"using deterministic synthetic data ({x.shape[0]} samples)")
        self.images_u8, self.labels_np = x, y
        self.num_classes, self.class_names = ncls, names
        # f64 reductions straight off the uint8 slab (no float copy of the set)
        self.data_mean = (x.mean(axis=(0, 1, 2), dtype=np.float64) / 255.0).tolist()
        ex2 = np.square(x, dtype=np.uint16).mean(axis=(0, 1, 2), dtype=np.float64) / 255.0**2
        self.data_std = np.sqrt(np.maximum(ex2 - np.square(self.data_mean), 0.0)).tolist()
        logger.debug(f"data mean: {self.data_mean}\tdata std: {self.data_std}")

    @property
    def metric_source(self):
        return self.images_u8, self.labels_np

    def transform_data(self) -> None:
        """A no-op kept for the reference's call sequence
        (dcgan_data_preprocessor.py:37-49): the transform is
        ``decode_batch``, run on the device inside each step."""

    def get_data_loader(self):
        """→ (a ``DeviceDataLoader`` over the set on ``cfg.device``, the
        metric source), the reference's (train loader, inception view)
        pair (dcgan_data_preprocessor.py:44-47,69-75)."""
        loader = DeviceDataLoader(self.images_u8, self.labels_np, self.cfg.batch_size,
                                  seed=self.cfg.seed, shuffle=True, device=self.cfg.device)
        return loader, self.metric_source


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Class ids (N,) → f32 one-hot (N, K) on the labels' device."""
    return F.one_hot(labels.long(), num_classes).float()


class CGANDataPreprocessor(DCGANDataPreprocessor):
    """Conditional data (reference cgan_data_preprocessor.py:11-94): adds
    the index → class-name map and ``one_hot``. The trainer keeps the labels
    on the device as int64 and gathers them by the images' index."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.idx_to_labels = dict(enumerate(self.class_names))

    def one_hot(self, labels: torch.Tensor) -> torch.Tensor:
        return one_hot(labels, self.num_classes)
