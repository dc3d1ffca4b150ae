"""Serving: load a reference DCGAN or CGAN checkpoint and generate images —
port of ``jckx/serve.py`` (``validate_sample_args``, ``tanh_to_u8``,
``GeneratorService`` and the one-shot CLI).

    python -m jckx_torch.serve --ckpt model.pt -n 64 -o samples.png \
        [--labels 3,17,42] [--batch_size 512] [--seed 0] [--device cpu]

The service reads the reference's torch ``.pt`` checkpoint (what
``jckx.serve`` imports), infers the family, geometry and class count from
its weights, runs on the card unless ``device`` names another, and renders
every batch through the hand-written fused BN + ReLU kernel
(``kernels/csrc/fused_bn_act.cu``): four launches per generator forward.

Each request draws z on the device from a ``torch.Generator`` seeded by
(seed, request counter), renders, converts tanh output to uint8 on the
device, and copies only the uint8 payload to the host. Every batch renders
the full batch size and is trimmed afterwards: under batch-statistic BN the
batch is part of the function, so a short final batch would change the
images. A CGAN request with ``labels`` gives row ``i`` of the request the
class ``labels[i % len(labels)]`` (``jckx/serve.py:383-387``); without
them each batch draws random classes from the request's generator, after
its z (``:292-293``).

Not ported yet: HTTP serving, ``--watch``, interpolation, truncation,
int8, the sub-pixel ConvTranspose, mesh sharding and sealed ``.jaxexp``
artifacts.
"""

from __future__ import annotations

import argparse
import hashlib
from typing import Optional, Sequence

import numpy as np
import torch

from jckx_torch.checkpoint.torch_convert import load_reference_checkpoint
from jckx_torch.data.pipeline import one_hot
from jckx_torch.logging.artifacts import save_image_grid
from jckx_torch.models.cgan import CGenerator
from jckx_torch.models.dcgan import Generator
from jckx_torch.utils.device import resolve_device

# undrained batches a request may hold on the device (6 MiB each at 64², bs512)
WINDOW = 8


def validate_sample_args(n: int, labels, conditional: bool):
    """Request validation → normalized labels (empty selection means
    random classes)."""
    if n < 1:
        raise ValueError(f"sample(n={n}): n must be >= 1")
    # len(), not truthiness: a numpy label array raises on bool()
    if labels is not None and len(labels) == 0:
        labels = None
    if labels is not None and not conditional:
        # silently returning random unconditional samples would let the
        # caller believe class control worked
        raise ValueError(
            "labels were given but this checkpoint is unconditional "
            "(DCGAN) — class-conditional sampling needs a CGAN checkpoint")
    return labels


def tanh_to_u8(imgs: torch.Tensor) -> torch.Tensor:
    """tanh output in [-1, 1] → uint8 on the tensor's device. floor (not
    round), as jckx's ``tanh_to_u8`` and numpy's ``astype(uint8)``."""
    x = imgs.float() * 0.5 + 0.5
    return torch.floor(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


def pipelined_sample(n: int, bs: int, render) -> np.ndarray:
    """Render ``ceil(n / bs)`` full batches (``render(made)`` → a device
    batch, ``made`` the rows of the request before it), trim the last, and
    copy the uint8 payloads to the host in order, holding at most
    ``WINDOW`` undrained batches on the device."""
    out, made = [], 0
    inflight = []  # (device_imgs, take)

    def drain_one():
        imgs, take = inflight.pop(0)
        out.append(imgs[:take].cpu().numpy())

    while made < n:
        inflight.append((render(made), min(bs, n - made)))
        made += inflight[-1][1]
        if len(inflight) >= WINDOW:
            drain_one()
    while inflight:
        drain_one()
    return np.concatenate(out)


def _request_seed(seed: int, count: int) -> int:
    """A 63-bit generator seed from (seed, request counter)."""
    digest = hashlib.sha256(f"{seed}:{count}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class GeneratorService:
    """Checkpoint-backed DCGAN or CGAN image generator; the family, the
    geometry and the class count are inferred from the weights."""

    def __init__(
        self,
        ckpt_path: str,
        batch_size: int = 512,
        compute_dtype=torch.bfloat16,
        seed: int = 0,
        device=None,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size {batch_size} must be >= 1")
        if not ckpt_path.endswith(".pt"):
            raise ValueError(
                f"{ckpt_path}: the port serves reference torch .pt "
                f"checkpoints. A jckx .ckpt is flax msgpack: convert it with "
                f"`python -m jckx.convert --src {ckpt_path} --dst model.pt` "
                f"(sealed .jaxexp artifacts are not served yet)")
        self.device = resolve_device(device)
        self.conditional, self.geo, self.num_classes, state_dict = \
            load_reference_checkpoint(ckpt_path)
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.seed = seed
        self._count = 0
        self.G = CGenerator(self.geo, self.num_classes) if self.conditional else Generator(self.geo)
        self.G.load_state_dict(state_dict, strict=True)
        self.G.to(self.device).requires_grad_(False)

    def render(self, z: torch.Tensor, labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One generator forward on ``z`` (B, z_dim), and for CGAN the class
        ids ``labels`` (B,) → uint8 (B, S, S, C) on the service's device."""
        if (labels is not None) != self.conditional:
            raise ValueError("render takes class labels for a CGAN checkpoint, and only then")
        with torch.inference_mode():
            z = z.to(self.device)
            if labels is None:
                return tanh_to_u8(self.G(z, self.compute_dtype))
            onehot = one_hot(labels.to(self.device), self.num_classes)
            return tanh_to_u8(self.G(z, onehot, self.compute_dtype))

    def sample(self, n: int, labels: Optional[Sequence[int]] = None,
               seed: Optional[int] = None) -> np.ndarray:
        """→ uint8 images (n, S, S, C). ``seed`` makes the request
        deterministic; without it each request draws fresh noise. ``labels``
        (CGAN only) cycle over the request's rows; without them each batch
        draws random classes."""
        labels = validate_sample_args(n, labels, self.conditional)
        if labels is not None:
            labels = np.asarray(labels, np.int64)
            if labels.min() < 0 or labels.max() >= self.num_classes:
                raise ValueError(f"labels must lie in [0, {self.num_classes})")
            labels = torch.from_numpy(labels).to(self.device)
        if seed is None:
            self._count += 1
            gseed = _request_seed(self.seed, self._count)
        else:
            gseed = _request_seed(seed, 0)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(gseed)
        bs = self.batch_size
        rows = torch.arange(bs, device=self.device)

        def render(made: int):
            z = torch.randn((bs, self.geo.z_dim), generator=gen, device=self.device)
            if not self.conditional:
                return self.render(z)
            if labels is None:
                lab = torch.randint(0, self.num_classes, (bs,), generator=gen, device=self.device)
            else:
                lab = labels[(made + rows) % labels.numel()]
            return self.render(z, lab)

        return pipelined_sample(n, bs, render)


def get_args(argv=None):
    p = argparse.ArgumentParser(description="jckx_torch generator serving")
    p.add_argument("--ckpt", required=True, help="reference torch .pt checkpoint")
    p.add_argument("-n", "--num", type=int, default=64)
    p.add_argument("-o", "--out", default="samples.png")
    p.add_argument("--labels", default="", help="comma-separated class ids (CGAN)")
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="default cuda; 'cpu' runs the plain PyTorch path")
    return p.parse_args(argv)


def main(args) -> None:
    if args.num < 1:
        raise SystemExit(f"-n/--num must be >= 1, got {args.num}")
    labels = [int(x) for x in args.labels.split(",") if x] or None
    svc = GeneratorService(args.ckpt, batch_size=args.batch_size,
                           seed=args.seed, device=args.device)
    imgs = svc.sample(args.num, labels=labels)
    save_image_grid(args.out, imgs)
    print(f"wrote {args.num} samples to {args.out}")


if __name__ == "__main__":
    main(get_args())
