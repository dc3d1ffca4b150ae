"""The metrics engine: InceptionV3 features → FID / IS / intra-FID — port of
``jckx/metrics/metrics.py`` (``Metrics``: the backbone, the real-feature
cache, ``extract_features``, ``inception_score``, ``fid``, ``intra_fid``).

- Backbone: ``metric_backbone`` when given (a missing or unreadable file
  raises), else the fine-tuned ``loss_bset.npz`` / ``loss_bset.pt`` under
  ``<save_root>/iception_v3`` or ``./save/iception_v3`` (the reference's
  path, sic), else the seeded random backbone of jckx's ``init(0)`` with
  jckx's warning: FID / IS are then self-consistent, for best-metric
  checkpoints, but not comparable to the reference's values.
- The image path, on the device in the compute dtype: GAN output in
  [-1, 1] (or uint8 / 255 for the real set) → [0, 1] → bilinear to 299 →
  ImageNet normalization → InceptionV3 → logits, which are both IS's
  class scores and FID's features, as in the reference. A host set (the
  real images) goes up in pinned slabs of at most 256 MB, each slab's copy
  behind the previous slab's forwards; the trainer's fakes are already on
  the device.
- Real features over the metric source are cached in
  ``<cache_dir>/metric_data_jckx_torch_<fingerprint>.npz``; the
  fingerprint covers a strided sample of the data, its labels, the class
  count and the backbone's content, so a stale cache is never read. The
  file name is the port's own: jckx's cache is never read or written.
- Intra-FID (reference metrics.py:132-141): the FID of each CIFAR-100
  superclass, real against fake, summed over the superclasses that both
  sides populate and divided by 100, the reference's divisor for 20
  superclasses. The fakes are the class-major eval grid, 10 per class.
- KID and precision / recall / density / coverage (``kid``, ``prdc``;
  ``metrics/extra.py``) in the same feature space, from the same
  extraction; the real set's k-NN radii are computed once per k.
- ``fast_stem`` (default: the config's ``eval_fast_stem``) runs the
  backbone's first convolution in its space-to-depth form; its real
  features are cached under their own key (jckx's ``-s2d`` tag), since
  the two stems agree only to rounding.
- ``mesh`` (a process mesh; jckx ``:59-120``): the extraction runs
  data-parallel. The batch is rounded up to a multiple of the data axis
  (jckx's ``_round_bs``), each rank takes its rows of every batch (a host
  set uploads only those) and the features are gathered in order, so
  every rank holds all of them and computes the same metrics. The forward
  is per-sample (running-statistic BN), so the split changes nothing but
  rounding. The ranks agree on whether the real-feature cache exists, and
  rank 0 alone writes it.
- On the card each batch's forward (resize, normalization, InceptionV3) is
  one replay of a CUDA graph (``program``, ``utils/graphs.GraphedProgram``;
  jckx jits its feature pipelines, ``jckx/metrics/metrics.py:125-126``,
  ``:504-510``): the last batch is padded to full size, so one graph
  serves a whole extraction, a device set and the host set's slabs alike
  (the slab copies stay outside it). Over a NCCL mesh each rank replays
  its rows' forward (the gather of the features stays outside the graph).
  Eager on the CPU, over gloo and under ``--sanitize`` (the log says
  why); ``program = None`` forces the eager route.
"""

from __future__ import annotations

import functools
import hashlib
import os
from typing import Optional

import numpy as np
import torch

from jckx_torch.data.datasets import FINE_TO_SUPERCLASS
from jckx_torch.data.pipeline import resize_bilinear
from jckx_torch.logging.main_logger import MainLogger
from jckx_torch.metrics import extra, inception_v3
from jckx_torch.metrics.fid import (frechet_distance, inception_score_from_probs, intra_fid_sum,
                                    mean_and_cov)
from jckx_torch.utils.device import resolve_device
from jckx_torch.utils.graphs import GraphedProgram, graph_for

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
INTRA_FID_DIVISOR = 100.0  # the reference's, for its 20 superclasses (metrics.py:141)


def inception_logits(backbone, mean: torch.Tensor, std: torch.Tensor, compute_dtype,
                     fast_stem: bool, x01: torch.Tensor) -> torch.Tensor:
    """[0, 1] NHWC in the compute dtype → logits (N, K), f32: bilinear to
    299, ImageNet normalization (``mean`` / ``std`` device tensors), the
    backbone."""
    x = resize_bilinear(x01, 299)
    if x.shape[-1] == 1:  # grayscale → 3 channels
        x = x.repeat(1, 1, 1, 3)
    return backbone((x - mean.to(x.dtype)) / std.to(x.dtype), compute_dtype, fast_stem=fast_stem)


def _content_sig(sd: dict) -> str:
    """A hash of every tensor's name, shape and a ≤4096-element strided
    sample, in sorted-key order."""
    h = hashlib.sha1()
    for k in sorted(sd):
        a = sd[k].detach().cpu().reshape(-1)
        h.update(f"{k}{tuple(sd[k].shape)}".encode())
        stride = -(-a.numel() // 4096) if a.numel() else 1
        h.update(a[::stride].float().numpy().tobytes())
    return h.hexdigest()[:12]


class Metrics:
    def __init__(self, metric_source, config=None, backbone: Optional[inception_v3.InceptionV3] = None,
                 batch_size: int = 256, compute_dtype=torch.bfloat16, cache_dir: str = "./data",
                 num_classes: int = 100, device=None, fast_stem: Optional[bool] = None,
                 mesh=None):
        self._logger = MainLogger(config)
        self.mesh = mesh
        self.device = resolve_device(device if device is not None else getattr(config, "device", None))
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.num_classes = num_classes
        self.fast_stem = (bool(getattr(config, "eval_fast_stem", 0)) if fast_stem is None
                          else bool(fast_stem))
        if backbone is not None:
            self._backbone_sig = _content_sig(backbone.state_dict())
        else:
            backbone = self._load_backbone(config)
        self.backbone = backbone.to(self.device).eval()
        # made once: a host→device copy per batch would stop a capture
        mean, std = (torch.tensor(v, dtype=compute_dtype, device=self.device)
                     for v in (IMAGENET_MEAN, IMAGENET_STD))
        self._logits = functools.partial(inception_logits, self.backbone, mean, std,
                                         compute_dtype, self.fast_stem)
        graph, why_eager = graph_for(self.device, bool(getattr(config, "sanitize", False)), mesh)
        self.program = GraphedProgram(self._logits, self.device, graph, mesh) if graph else None
        self._logger.debug("metrics forward: " + ("one CUDA graph per batch shape" if graph
                                                  else f"eager, {why_eager}"))

        real_u8, real_labels = metric_source
        # superclass index maps (reference metrics.py:56-68); the fakes are
        # the class-major eval grid, 10 samples per class
        real_super = FINE_TO_SUPERCLASS[np.asarray(real_labels) % 100]
        fake_super = FINE_TO_SUPERCLASS[np.repeat(np.arange(num_classes), 10) % 100]
        self.real_superclass_idx = {s: np.nonzero(real_super == s)[0] for s in range(20)}
        self.fake_superclass_idx = {s: np.nonzero(fake_super == s)[0] for s in range(20)}
        # with K < 100 some buckets are empty on one side; an empty or
        # one-row bucket has no covariance, so intra-FID skips it
        self.active_superclasses = [
            s for s in range(20)
            if len(self.fake_superclass_idx[s]) > 1 and len(self.real_superclass_idx[s]) > 1]
        if len(self.active_superclasses) < 20:
            self._logger.warning(
                f"num_classes={num_classes}: only {len(self.active_superclasses)}/20 CIFAR-100 "
                f"superclasses populated — intra-FID sums over those only (divisor stays "
                f"{INTRA_FID_DIVISOR:g} for reference comparability)")
        self._real_super_stats = None
        self._real_knn_radii = {}

        tag = self._fingerprint(real_u8, real_labels) + ("-s2d" if self.fast_stem else "")
        cache = os.path.join(cache_dir, f"metric_data_jckx_torch_{tag}.npz")
        have = os.path.exists(cache)
        if mesh is not None:
            have = not mesh.any(not have)  # extract together unless every rank has it
        if have:
            with np.load(cache) as z:
                self.real_features = z["features"]
            self._logger.debug(f"loaded cached real features {self.real_features.shape}")
        else:
            self._logger.debug(f"extracting real features for {len(real_labels)} images")
            self.real_features = self._extract_u8(real_u8)
            if mesh is None or mesh.lead:
                os.makedirs(cache_dir, exist_ok=True)
                tmp = f"{cache}.tmp.{os.getpid()}.npz"
                np.savez_compressed(tmp, features=self.real_features)
                os.replace(tmp, cache)
        self._real_mu_sigma = None

    # ------------------------------------------------------------ backbone

    def _load_backbone(self, config) -> inception_v3.InceptionV3:
        path = getattr(config, "metric_backbone", "") if config is not None else ""
        if path and not os.path.exists(path):
            raise FileNotFoundError(
                f"--metric_backbone {path!r} does not exist; refusing to fall back to "
                f"another backbone for explicitly requested metrics")
        candidates = [path] if path else []
        roots = []
        save_root = getattr(config, "save_root", "") if config is not None else ""
        if save_root:
            roots.append(os.path.join(save_root, "iception_v3"))
        if os.path.normpath("./save/iception_v3") not in {os.path.normpath(r) for r in roots}:
            roots.append("./save/iception_v3")
        candidates += [os.path.join(r, f) for r in roots for f in ("loss_bset.npz", "loss_bset.pt")]
        for c in candidates:
            if not os.path.exists(c):
                continue
            if c.endswith(".npz"):
                with np.load(c) as zf:
                    net = inception_v3.from_jckx_flat(dict(zf))
            else:
                net = inception_v3.from_torchvision(
                    torch.load(c, map_location="cpu", weights_only=True))
            self._backbone_sig = _content_sig(net.state_dict())
            self._logger.debug(f"metric backbone loaded from {c}")
            return net
        self._logger.warning(
            "no fine-tuned InceptionV3 checkpoint found — using a seeded random backbone; "
            "FID/IS are self-consistent but NOT comparable to the reference's absolute values")
        self._backbone_sig = f"seeded-random-0-{self.num_classes}"
        return inception_v3.init(0, num_classes=self.num_classes)

    def _fingerprint(self, images_u8, labels) -> str:
        h = hashlib.sha1()
        images_u8 = np.asarray(images_u8)
        n = images_u8.shape[0]
        h.update(np.int64(n).tobytes())
        # a strided sample across the whole set, not a prefix
        h.update(np.ascontiguousarray(images_u8[:: max(1, n // 64)][:64]).tobytes())
        h.update(np.ascontiguousarray(np.asarray(labels)).tobytes())
        h.update(np.int32(self.num_classes).tobytes())
        h.update(self._backbone_sig.encode())
        return h.hexdigest()[:12]

    # ------------------------------------------------------------ features

    def _features01(self, x01: torch.Tensor) -> torch.Tensor:
        """[0, 1] NHWC in the compute dtype → logits (N, K), f32: a graph
        replay on the card (``inception_logits``)."""
        if self.program is not None:
            return self.program(x01)
        return self._logits(x01)

    # host sets are uploaded in slabs of at most this many bytes (jckx's
    # metrics.py:376-378): one copy each, a bounded share of the card
    _SLAB_BYTES = 256 * 1024 * 1024

    def _batched(self, images, to01) -> np.ndarray:
        """Features of every row of ``images`` in batches of ``batch_size``
        (over a mesh: rounded up to a multiple of its data axis, each rank
        taking its rows of every batch); a short last batch is padded with
        copies of the last row (the forward is per-sample). A device tensor
        is indexed in place. A host array goes up in slabs of whole
        batches, at most ``_SLAB_BYTES`` each, through ``PinnedSlabs``
        (jckx's ``_batched``, ``:380-437``): slab s+1 is gathered and its
        copy enqueued while the card runs slab s's forwards. Both give the
        same batches, so the same features."""
        n = images.shape[0]
        if n == 0:
            return np.zeros((0, self.num_classes), np.float32)
        size, rank = (1, 0) if self.mesh is None else (self.mesh.size, self.mesh.rank)
        bs = -(-min(self.batch_size, n) // size) * size
        nb, lb = -(-n // bs), bs // size
        # this rank's rows of every batch, the last batch padded with the last row
        rows = np.minimum(np.arange(nb * bs).reshape(nb, bs)[:, rank * lb:(rank + 1) * lb], n - 1)
        with torch.inference_mode():
            if isinstance(images, torch.Tensor):
                idx = torch.from_numpy(rows).to(images.device)
                outs = [self._features01(to01(images.index_select(0, i).to(self.device)))
                        for i in idx]
            else:
                outs = self._slab_features(np.asarray(images), rows, to01)
            feats = torch.cat(outs)  # (nb·lb, K): this rank's rows, batch-major
            if self.mesh is not None:
                feats = self.mesh.all_gather_rows(feats).reshape(size, nb, lb, -1)
                feats = feats.transpose(0, 1).reshape(nb * bs, -1)
            return feats[:n].cpu().numpy()

    def _slab_features(self, images: np.ndarray, rows: np.ndarray, to01) -> list:
        """Features of ``images[rows[b]]`` for every batch b, uploaded in slabs."""
        from jckx_torch.data.pipeline import PinnedSlabs

        nb, lb = rows.shape
        per_slab = min(nb, max(1, self._SLAB_BYTES // (images[:1].nbytes * lb)))  # batches
        dtype = torch.from_numpy(np.empty(0, images.dtype)).dtype
        slabs = PinnedSlabs(self.device, [(images.shape[1:], dtype)], per_slab * lb)

        def upload(first: int):
            take = rows[first:first + per_slab].ravel()
            (host,) = slabs.fill(take.size)
            np.take(images, take, axis=0, out=host, mode="clip")
            return slabs.upload(take.size)

        outs = []
        nxt = upload(0)
        for first in range(0, nb, per_slab):
            (dev,) = slabs.use(nxt)
            outs += [self._features01(to01(dev[i:i + lb])) for i in range(0, dev.shape[0], lb)]
            del dev
            if first + per_slab < nb:
                nxt = upload(first + per_slab)
        return outs

    def _extract_u8(self, images_u8) -> np.ndarray:
        cd = self.compute_dtype
        return self._batched(np.asarray(images_u8), lambda u8: u8.to(cd) / 255.0)

    def extract_features(self, images_tanh) -> np.ndarray:
        """GAN output in [-1, 1], (N, S, S, C) on any device → logits, f32."""
        cd = self.compute_dtype
        return self._batched(images_tanh, lambda x: 0.5 * x.to(cd) + 0.5)

    # ------------------------------------------------------------- metrics

    def inception_score(self, images_tanh=None, splits: int = 10,
                        logits: Optional[np.ndarray] = None) -> float:
        """IS (reference metrics.py:97-110); ``logits`` reuses an extraction."""
        if logits is None:
            logits = self.extract_features(images_tanh)
        probs = torch.softmax(torch.as_tensor(logits, dtype=torch.float32), dim=-1)
        return float(inception_score_from_probs(probs, splits=splits))

    def fid(self, images_tanh=None, intra_fid: bool = False, label: int = 0,
            features: Optional[np.ndarray] = None) -> float:
        """FID(real set ‖ generated) (reference metrics.py:113-129); with
        ``intra_fid``, against the real rows of superclass ``label`` only."""
        gen = features if features is not None else self.extract_features(images_tanh)
        if intra_fid:
            real = self.real_features[self.real_superclass_idx[label]]
            mu1, s1 = mean_and_cov(torch.from_numpy(real))
        else:
            if self._real_mu_sigma is None:
                self._real_mu_sigma = mean_and_cov(torch.from_numpy(self.real_features))
            mu1, s1 = self._real_mu_sigma
        mu2, s2 = mean_and_cov(torch.as_tensor(gen, dtype=torch.float32))
        return float(frechet_distance(mu1, s1, mu2, s2))

    def intra_fid(self, images_tanh=None, features: Optional[np.ndarray] = None) -> float:
        """Σ_superclass FID / 100 (reference metrics.py:132-141). When every
        active superclass has as many fakes (K = 100: 50 each), all FIDs
        go in one batched call; otherwise (K < 100) one call each."""
        feats = features if features is not None else self.extract_features(images_tanh)
        active = self.active_superclasses
        if len({len(self.fake_superclass_idx[s]) for s in active}) == 1:
            mu_r, sigma_r = self._real_superclass_stats()
            idx = torch.from_numpy(np.stack([self.fake_superclass_idx[s] for s in active]))
            total = float(intra_fid_sum(torch.as_tensor(feats, dtype=torch.float32), idx,
                                        mu_r, sigma_r))
        else:
            total = sum(self.fid(features=feats[self.fake_superclass_idx[s]], intra_fid=True,
                                 label=s) for s in active)
        return total / INTRA_FID_DIVISOR

    def kid(self, images_tanh=None, features: Optional[np.ndarray] = None, subsets: int = 100,
            subset_size: int = 1000, seed: int = 0, perms=None) -> tuple:
        """Kernel Inception Distance (real set ‖ generated) → (mean, std)
        (``jckx/metrics/metrics.py:591-603``); ``features`` reuses an
        extraction, ``perms`` replaces the subset draws of ``seed``."""
        gen = features if features is not None else self.extract_features(images_tanh)
        return extra.kid(self.real_features, gen, subsets=subsets, subset_size=subset_size,
                         seed=seed, perms=perms, device=self.device)

    def prdc(self, images_tanh=None, features: Optional[np.ndarray] = None, k: int = 3) -> dict:
        """Precision / recall / density / coverage of generated against real
        (``:605-621``); the real set's k-NN radii are swept once per k."""
        gen = features if features is not None else self.extract_features(images_tanh)
        if k not in self._real_knn_radii:
            self._real_knn_radii[k] = extra.real_knn_radii(self.real_features, k,
                                                           device=self.device)
        return extra.manifold_metrics(self.real_features, gen, k=k, device=self.device,
                                      real_radii=self._real_knn_radii[k])

    def _real_superclass_stats(self):
        """(S, d) means and (S, d, d) covariances of the real features of
        each active superclass, computed once and kept."""
        if self._real_super_stats is None:
            stats = [mean_and_cov(torch.from_numpy(self.real_features[self.real_superclass_idx[s]]))
                     for s in self.active_superclasses]
            self._real_super_stats = (torch.stack([m for m, _ in stats]),
                                      torch.stack([c for _, c in stats]))
        return self._real_super_stats
